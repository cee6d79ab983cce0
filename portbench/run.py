"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up builds the cell's index from data
made on the card from ``--seed`` and warms its shapes; then, with
``--trace 0``, the traffic runs for ``--seconds`` and the cell's
end-to-end metrics are taken on the host clock
(``portbench/end_to_end/<metric>.py``); with ``--trace 1`` a fixed
number of steps runs under torch.profiler and the cell's per-layer
metrics are read from the trace (``portbench/metrics/<metric>.py``).
After the window the program's answers to a sample of the window's
query batches, drawn from the seed, are compared with the plain
reference's (``portbench/check.py``).  The last line of standard output
is one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error and the result's last key.

Exits 2 without a result where the card is missing, and 3 where a JAX
module was loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# the program builds its kernels under build/ in the checkout; caches of
# torch's own builders go there too, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))
# one host thread for CPU operators: idle pool threads spinning beside
# the service's engine thread spread its timings
os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

from portbench import spec  # noqa: E402
from portbench.check import Verdict, judge  # noqa: E402
from portbench.drive import Driver  # noqa: E402
from portbench.reference import lsh  # noqa: E402
from portbench.window import Window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (Linux:
    /proc; elsewhere the time of this call)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.perf_counter() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX package's or the
    reference package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def verify(drv: Driver, recs) -> Verdict:
    """The program's answers to ``recs`` against the plain reference."""
    cfg, traffic = drv.cfg, drv.traffic
    dev = traffic.base.device
    last = max(r.step for r in recs) + 1
    n_rows = traffic.first_gid(last) if drv.mix.get("insert") else (
        traffic.first_gid(0))
    x = (traffic.base if n_rows == traffic.n else
         traffic.points_of(torch.arange(n_rows, device=dev)))
    t_in, t_out = drv.live_intervals(n_rows)
    store = lsh.Store(lsh.Hasher(cfg, lsh.sample_params(cfg, dev)), x,
                      torch.as_tensor(t_in, device=dev),
                      torch.as_tensor(t_out, device=dev))
    cr2 = lsh.cr2_of(cfg)
    out = Verdict()
    for rec in recs:
        q = torch.as_tensor(traffic.queries(rec.step), device=dev)
        gids, dists = drv.answers(rec)
        qids = torch.arange(q.shape[0], device=dev)
        out.add(judge(store, q, qids, rec.seq, gids, dists, cfg["K"], cr2))
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_proc=None) -> dict:
    """One run of ``cell``; returns the result object."""
    t_proc = time.perf_counter() if t_proc is None else t_proc
    dev = torch.device(device)
    drv = Driver(cell.config, cell.mix, seed, dev)
    drv.setup()
    drops0 = drv.dropped()
    metrics, extra = {}, {}
    # set-up's garbage is not the window's, and its long-lived objects
    # are not scanned again by the window's collections
    gc.collect()
    gc.freeze()
    if trace:
        from portbench.trace import Tracer
        with Tracer(dev) as tr:
            recs = drv.window(steps=cell.mix["trace_steps"])
        tr.batches = sum(r.kind == "query" for r in recs)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = tr.breakdown()
        del tr
    else:
        recs = drv.window(seconds=seconds)
        w = Window(recs, drv.t_start, drv.t_start - t_proc)
        for m in cell.end_to_end:
            v = spec.end_to_end_reader(m["name"])(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # routed rows dropped: the service counts them by no batch (failed
    # here); a synchronous call with drops is failed whole
    dropped = drv.dropped() - drops0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    drv.close()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    picked = sorted(drv.sample.kept, key=lambda r: r.seq)
    verdict = verify(drv, picked)
    failed = sum(r.n if r.kind == "query" else 1 for r in recs
                 if r.error) + dropped
    checks = {"wrong_answers": verdict.wrong,
              "dist_rel_err": verdict.dist_rel_err}
    correct = failed == 0 and bool(picked) and all(
        checks[k] <= cell.checks[k]["limit"] for k in checks)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak), **extra}
    result = {"correct": correct,
              "attempted": sum(r.n if r.kind == "query" else 1
                               for r in recs),
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": checks[k],
                            "limit": cell.checks[k]["limit"]}
                        for k in checks}
    result["_notes"] = {"compared": verdict.compared,
                        "excused": verdict.excused,
                        "drops": dropped + sum(r.drops for r in recs),
                        "batches_compared": len(picked),
                        "examples": verdict.examples}
    return result


def main(argv=None) -> int:
    t_proc = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_proc=t_proc)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    notes = result.pop("_notes")
    print(f"portbench: {args.workload} seed {args.seed}: compared "
          f"{notes['compared']} answers in {notes['batches_compared']} "
          f"batches, {notes['excused']} explained by float32 rounding, "
          f"drops {notes['drops']}", file=sys.stderr)
    for ex in notes["examples"]:
        print(f"portbench: wrong answer {json.dumps(ex)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
