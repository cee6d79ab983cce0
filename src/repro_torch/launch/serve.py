"""Serving driver: stand up the retrieval service (LM embedder +
distributed Layered-LSH index) and run batched query traffic, reporting
the paper's metrics (rows/query, load balance) beside latency.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
      --docs 2048 --batches 4              # reduced config (the default)
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced  # full
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --docs 256

The documents and query draws are the reference driver's
(``repro.launch.serve``): the port's threefry generator reproduces
jax.random's integers bitwise.  The weights come from a
``torch.Generator`` seeded with ``--seed``.  ``--snapshot-dir`` and
``--pipelined`` wait for the durability and pipeline parts of the port.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Scheme, prng
from repro_torch.core.index import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import RetrievalService

# logical shards on the one device (the reference takes one per device of
# its mesh; examples/serve_retrieval.py runs 8)
N_SHARDS = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the small same-family config (--no-reduced runs "
                         "the published width)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--docs", type=int, default=2048)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--scheme", default="layered",
                    choices=[s.value for s in Scheme])
    ap.add_argument("--L", type=int, default=16)
    ap.add_argument("--tables", type=int, default=1,
                    help="fused hash tables (recall lever; same number of"
                         " collectives per step for any value)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snapshot-dir", default=None,
                    help="not ported yet (ROADMAP Queue 1 item 7)")
    ap.add_argument("--pipelined", action="store_true",
                    help="not ported yet (ROADMAP Queue 1 item 8)")
    args = ap.parse_args(argv)
    if args.snapshot_dir:
        raise NotImplementedError(
            "--snapshot-dir needs snapshots and the write-ahead log, not "
            "ported yet (ROADMAP Queue 1 item 7)")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = init_params(cfg, generator=gen, device=dev)

    doc_tokens = prng.randint(prng.PRNGKey(1), (args.docs, 32),
                              0, cfg.vocab).numpy()
    t0 = time.monotonic()
    # the service bucket must divide by the shard count; round the
    # requested batch size up (pad-to-bucket absorbs the difference)
    bucket = -(-args.batch_size // N_SHARDS) * N_SHARDS
    svc = RetrievalService.build(
        cfg, model, doc_tokens, n_shards=N_SHARDS, device=dev,
        bucket_size=bucket, r=0.2, L=args.L, k=8, W=0.5,
        scheme=Scheme(args.scheme), seed=args.seed, n_tables=args.tables,
        pipelined=args.pipelined)
    load = svc.index.shard_load
    print(f"[serve] {cfg.name} on {dev}: built index: {args.docs} docs, "
          f"{time.monotonic() - t0:.1f}s, "
          f"load max/avg={load.max() / max(load.mean(), 1):.1f}, "
          f"drops={svc.index.build_result.drops}")

    lat = []
    for b in range(args.batches):
        kq = prng.fold_in(prng.PRNGKey(2), b)
        src = prng.randint(kq, (args.batch_size,), 0, args.docs).numpy()
        t0 = time.monotonic()
        svc.query(doc_tokens[src])
        lat.append(time.monotonic() - t0)
    svc.close()
    st = svc.service.stats
    if st.drops:
        raise RuntimeError(f"{st.drops} rows dropped (capacity overflow)")
    n = args.batches * args.batch_size
    print(f"[serve] {n} queries: p50 batch latency "
          f"{np.median(lat) * 1e3:.0f}ms, rows/query "
          f"{st.routed_rows / max(st.queries, 1):.2f} "
          f"(simple-LSH would ship ~{args.L}), scheme={args.scheme}")
    print(f"[serve] {st.summary()}")


if __name__ == "__main__":
    main()
