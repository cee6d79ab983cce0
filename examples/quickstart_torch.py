"""Quickstart on the PyTorch port: the paper in ~50 lines.

Builds a Layered-LSH index over a planted dataset on 8 shards (a leading
tensor axis), answers queries, and prints the network-traffic comparison
against the simple distributed implementation (the paper's headline
result), as ``examples/quickstart.py`` does with the JAX package.  Runs
on the card, or on the CPU with ``--device cpu``.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme, simulate
from repro_torch.data import planted_random


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda unless given")
    args = ap.parse_args(argv)
    data, queries, planted = planted_random(n=4096, m=512, d=64, r=0.3,
                                            device=args.device)

    print("== traffic: simple vs layered (analytic, 64 shards) ==")
    for scheme in (Scheme.SIMPLE, Scheme.LAYERED):
        cfg = LSHConfig(d=64, k=10, W=1.2, r=0.3, c=2.0, L=32,
                        n_shards=64, scheme=scheme)
        rep = simulate(cfg, data, queries, device=args.device)
        print(f"  {scheme.value:8s} rows/query={rep.fq_mean:6.2f} "
              f"bytes={rep.query_bytes:>9d}  "
              f"load max/avg={rep.query_load_max / max(rep.query_load_avg, 1):.1f}")

    print("== the index on 8 shards ==")
    cfg = LSHConfig(d=64, k=10, W=1.2, r=0.3, c=2.0, L=32, n_shards=8,
                    scheme=Scheme.LAYERED)
    index = DistributedLSHIndex(cfg, device=args.device)
    index.build(data)
    res = index.query(queries)
    found = np.isfinite(res.topk_dist[:, 0])
    recall = float(((res.topk_dist[:, 0] <= cfg.r) & found).mean())
    print(f"  routed rows/query: {res.fq.mean():.2f} "
          f"(Theorem 8 bound {cfg.fq_bound():.1f})")
    print(f"  recall@r: {recall:.3f}  overflow drops: {res.drops}")
    # correctness: every returned neighbour is within cr
    ok = res.topk_dist[found, 0] <= cfg.c * cfg.r + 1e-5
    print(f"  all {found.sum()} returned neighbours within cr: {ok.all()}")
    hit = res.topk_gid[:, 0] == planted.cpu().numpy()
    print(f"  planted neighbour found first for {hit.mean():.3f} of queries")


if __name__ == "__main__":
    main()
