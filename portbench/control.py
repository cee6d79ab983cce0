"""The control of a cell's comparison: the plain reference computed in
TF32 (the precision below the configuration's float32 with TF32 off)
put in the program's place, and judged by the same comparison as the
program (``portbench/check.py``).  It has to come out as not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        [--steps 200]

runs on the card at the cell's own size, without the program: the
requests of ``--steps`` steps are laid out as a run lays them out, the
same batches are sampled from each seed, and for each seed one line of
JSON gives the numbers compared beside the cell's limits.  A run of the
benchmark never runs it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import spec  # noqa: E402
from portbench.check import Verdict, judge  # noqa: E402
from portbench.drive import Driver  # noqa: E402
from portbench.reference import lsh  # noqa: E402


def control(cell: spec.Cell, seed: int, steps: int, device) -> dict:
    """The TF32 reference's answers to one seed's sampled batches, judged
    against the exact reference."""
    from portbench.drive import Reservoir
    dev = torch.device(device)
    drv = Driver(cell.config, cell.mix, seed, dev)
    sample = Reservoir(cell.mix["sample_batches"], seed)
    for rec in drv.dry(steps):
        if rec.kind == "query":
            sample.offer(rec)
    picked = sorted(sample.kept, key=lambda r: r.seq)
    cfg, traffic = drv.cfg, drv.traffic
    n_rows = traffic.first_gid(steps + cell.mix["warmup_steps"])
    x = (traffic.base if n_rows == traffic.n else
         traffic.points_of(torch.arange(n_rows, device=dev)))
    t_in, t_out = (torch.as_tensor(t, device=dev)
                   for t in drv.live_intervals(n_rows))
    params = lsh.sample_params(cfg, dev)
    exact = lsh.Store(lsh.Hasher(cfg, params, "exact"), x, t_in, t_out)
    low = lsh.Store(lsh.Hasher(cfg, params, "tf32"), x, t_in, t_out)
    cr2, K = lsh.cr2_of(cfg), cfg["K"]
    out = Verdict()
    for rec in picked:
        q = torch.as_tensor(traffic.queries(rec.step), device=dev)
        qids = torch.arange(q.shape[0], device=dev)
        cands, _ = low.candidates(q, qids, rec.seq, cr2, 0.0)
        g, d2 = lsh.top_k(cands, q.shape[0], K, cr2)
        dists = np.sqrt(d2.cpu().numpy()).astype(np.float32)
        out.add(judge(exact, q, qids, rec.seq, g.cpu().numpy(), dists, K,
                      cr2))
    return {"wrong_answers": out.wrong, "dist_rel_err": out.dist_rel_err,
            "compared": out.compared, "excused": out.excused}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = control(cell, seed, args.steps, "cuda")
        got.update(workload=args.workload, seed=seed,
                   limits={k: v["limit"] for k, v in cell.checks.items()},
                   seconds=time.perf_counter() - t0)
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
