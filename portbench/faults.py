"""Faults planted under the timed path, for reading what the comparison
makes of a broken program (``portbench/check.py``).  Each ``arm`` patches
the program in this process and returns the function that undoes it.

* ``insert_unchanged`` / ``delete_unchanged``: a write that returns its
  result but leaves the store as it was;
* ``half_the_batch``: the second half of every query batch answered with
  nothing (the rest answered as before);
* ``no_exchange``: the exchange between shards left out (each shard keeps
  what it would send);
* ``answer_altered``: the first gid of every non-empty answer altered
  where the return stage produces it.

    python3 -m portbench.faults --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--faults half_the_batch,no_exchange]

builds the cell once a seed, then runs a short window under each query
fault in turn and prints each one's numbers beside the cell's limits.
A run of the benchmark never runs it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

IMAX = 2 ** 31 - 1
QUERY_FAULTS = ("half_the_batch", "no_exchange", "answer_altered")


def arm(fault: str):
    """Patch the program with ``fault``; returns the undo."""
    from repro_torch.core import index as pindex
    cls = pindex.DistributedLSHIndex
    if fault == "insert_unchanged":
        name, real = "_insert", cls._insert

        def patched(self, points, g, gid_start):
            return pindex.InsertResult(self.shard_load, 0, points.shape[0],
                                       points.shape[0] * self.cfg.n_tables,
                                       self.store.capacity, gid_start)
    elif fault == "delete_unchanged":
        name, real = "_delete", cls._delete

        def patched(self, want):
            return pindex.DeleteResult(len(want) * self.cfg.n_tables,
                                       len(want), self.shard_load)
    elif fault in ("half_the_batch", "answer_altered"):
        name, real = "_return", cls._return

        def patched(self, ret, m, K):
            d, g, e = real(self, ret, m, K)
            d, g = d.clone(), g.clone()
            if fault == "half_the_batch":
                d[m // 2:] = torch.finfo(torch.float32).max
                g[m // 2:] = IMAX
            else:
                hit = g[:, 0] != IMAX
                g[hit, 0] += 1
            return d, g, e
    elif fault == "no_exchange":
        cls, name = pindex.AllToAll, "__call__"
        real = cls.__call__

        def patched(self, send):
            self.calls += 1
            return send
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(cls, name, patched)
    return lambda: setattr(cls, name, real)


def readings(cell, seed: int, seconds: float, faults, device="cuda"):
    """One set-up, then a window under each fault; their numbers."""
    from portbench.drive import Driver
    from portbench.run import verify
    drv = Driver(cell.config, cell.mix, seed, torch.device(device))
    drv.setup()
    out = {}
    try:
        for fault in faults:
            undo = arm(fault)
            try:
                recs = drv.window(seconds=seconds)
            finally:
                undo()
            v = verify(drv, sorted(drv.sample.kept, key=lambda r: r.seq))
            out[fault] = {"wrong_answers": v.wrong,
                          "dist_rel_err": v.dist_rel_err,
                          "compared": v.compared}
    finally:
        drv.close()
    return out


def main(argv=None) -> int:
    from portbench import spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", default=",".join(QUERY_FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.faults: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    faults = args.faults.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(cell, seed, args.seconds, faults)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "faults": got,
                          "limits": {k: v["limit"]
                                     for k, v in cell.checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
