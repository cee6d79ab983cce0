"""Dry run: every (architecture x assigned shape) cell of the reference's
``launch/steps.py``, built by ``launch/steps.py`` and run once on the meta
device under ``launch/op_cost.Counter``, on any host (no card, nothing
allocated): whether the cell fits one card, its FLOPs and bytes, the
launches of each hand-written kernel (its ``plan`` taking the cell's
shapes, as on the card) and its roofline on an NVIDIA H100
(``launch/hlo_analysis.py``).  The reference's ``launch/dryrun.py``
lowers and compiles each cell for a 256- or 512-device mesh; one card has
no mesh to choose, so there is no ``--mesh``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  # a cell cut to run on the card: prefill_32k at one sequence
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape prefill_32k --batch 1

Results are written incrementally to experiments/dryrun_torch/<cell>.json
(a cell already there is read back unless ``--force``).  The bytes are
unfused -- every op's inputs read and outputs written once -- an upper
bound on the card's traffic; the peak is the live device bytes at the
caching allocator's block size, the step's arguments (parameters, AdamW
moments, cache, inputs) included.  ``fits`` holds the peak against the
card's memory where a card is present, else against 79.2 GiB, the H100
80GB's usable memory.  A cell that fails is recorded and the run exits
non-zero, as the reference's does.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import op_cost
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.tree import leaves

OUT_DIR = "experiments/dryrun_torch"


def cell_name(arch: str, shape: str, batch=None, microbatches=None) -> str:
    """<arch>__<shape>[__b<batch>][__mb<microbatches>], the arch by its
    config's name whatever alias names it."""
    name = f"{get_config(arch).name}__{shape}"
    for tag, v in (("b", batch), ("mb", microbatches)):
        if v is not None:
            name += f"__{tag}{v}"
    return name


def capacity_bytes() -> tuple[int, str]:
    """The memory ``fits`` holds a cell's peak to, and whose it is."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.total_memory, props.name
    return ha.USABLE_BYTES, "NVIDIA H100 80GB, usable (79.2 GiB)"


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape: str, out_dir: str = OUT_DIR,
             force: bool = False, *, batch=None,
             microbatches=None) -> dict:
    """One cell's record (written to ``out_dir``/<cell>.json).  ``batch``
    cuts the shape's global batch; ``microbatches`` goes to a train
    cell's builder."""
    cell = cell_name(arch, shape, batch, microbatches)
    out_path = os.path.join(out_dir, cell + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch)
    rec = {"arch": cfg.name, "shape": shape, "cell": cell, "mesh": "one card",
           "ok": False}
    ok, reason = steps_lib.shape_applicable(cfg, shape)
    if not ok:
        rec.update({"skipped": True, "reason": reason, "ok": True})
        _write(out_path, rec)
        print(f"[dryrun] {cell}: SKIP ({reason})")
        return rec

    try:
        s = steps_lib.SHAPES[shape]
        kw = ({"microbatches": microbatches}
              if s["kind"] == "train" and microbatches else {})
        t0 = time.monotonic()
        built = steps_lib.build_step(cfg, make_production_mesh(), shape,
                                     batch=batch, **kw)
        model = built.args[0]
        if s["kind"] == "train":
            parts = {"params_bytes": _bytes(built.args[1]),
                     "opt_state_bytes": _bytes(built.args[2]),
                     "cache_bytes": 0, "inputs_bytes": _bytes(built.args[3:])}
        else:
            parts = {"params_bytes": _bytes(list(model.parameters())),
                     "opt_state_bytes": 0,
                     "cache_bytes": _bytes(built.args[1]),
                     "inputs_bytes": _bytes(built.args[2:])}
        t_build = time.monotonic() - t0
        t0 = time.monotonic()
        with op_cost.Counter() as c:
            held = c.hold([list(model.parameters()), built.args[1:]])
            out = built.fn(*built.args)
            del out
        t_run = time.monotonic() - t0
        B = batch or s["batch"]
        n_tokens = B * (s["seq"] if s["kind"] != "decode" else 1)
        mf = ha.model_flops(cfg, shape, n_tokens)
        rl = ha.roofline(flops=c.flops, hbm_bytes=c.bytes, coll_bytes=0,
                         model_flops=mf, n_devices=1)
        cap, cap_of = capacity_bytes()
        kernels = {name: dict(k, plan_ok=True)
                   for name, k in sorted(c.kernels.items())}
        rec.update({
            "ok": True,
            "n_devices": 1,
            "batch": B, "seq": s["seq"], "kind": s["kind"],
            "microbatches": (microbatches or steps_lib.TRAIN_MICROBATCHES)
            if s["kind"] == "train" else None,
            "build_s": round(t_build, 2),
            "run_s": round(t_run, 2),
            "memory": {
                **parts,
                "held_bytes": held,
                "peak_bytes": c.peak,
                "step_peak_bytes": c.peak - held,
                "peak_gib": round(c.peak / 2**30, 3),
                "capacity_bytes": cap,
                "capacity_of": cap_of,
                "fits": c.peak <= cap,
            },
            "cost": {"flops": c.flops, "bytes": c.bytes,
                     "bytes_note": "unfused: every op's inputs read and "
                                   "outputs written once, an upper bound",
                     "unknown_trip_loops": c.unknown_trip_loops},
            "kernels": kernels,
            "roofline": rl.to_dict(),
        })
        print(f"[dryrun] {cell}: OK run={t_run:.1f}s peak="
              f"{c.peak / 2**30:.2f} GiB fits={c.peak <= cap} "
              f"bottleneck={rl.bottleneck} terms(c/m)=({rl.compute_s:.2e},"
              f"{rl.memory_s:.2e})s mfu~{rl.mfu:.2f}")
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        rec.update({"error": str(e)[:2000],
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[dryrun] {cell}: FAIL {e}")
    _write(out_path, rec)
    return rec


def _write(path: str, rec: dict):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(steps_lib.SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="a train cell's microbatches (default "
                         f"{steps_lib.TRAIN_MICROBATCHES})")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(steps_lib.SHAPES) if (args.all or args.shape is None) \
        else [args.shape]

    results = []
    for arch in archs:
        for shape in shapes:
            results.append(run_cell(arch, shape, args.out, force=args.force,
                                    batch=args.batch,
                                    microbatches=args.microbatches))
    n_ok = sum(r.get("ok", False) for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells OK")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
