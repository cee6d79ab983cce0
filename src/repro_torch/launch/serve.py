"""Serving driver: stand up the retrieval service (LM embedder +
distributed Layered-LSH index) and run batched query traffic, reporting
the paper's metrics (rows/query, load balance) beside latency.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
      --docs 2048 --batches 4              # reduced config (the default)
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced  # full
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --docs 256
  SNAP=$(mktemp -d)   # a fresh directory: the service owns what is in it
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --docs 256 \\
      --snapshot-dir "$SNAP" --snapshot-every 2 --pipelined  # twice: the
      # second run is a WARM restart from the snapshot + WAL tail
  rm -rf "$SNAP"

The documents and query draws are the reference driver's
(``repro.launch.serve``): the port's threefry generator reproduces
jax.random's integers bitwise.  The weights come from a
``torch.Generator`` seeded with ``--seed``.  ``--snapshot-dir`` makes
the service durable (WAL + snapshots, warm restart), ``--pipelined``
serves through ``AsyncLSHService``; both with the reference's meanings.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import persist
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
                    help="durability: WAL every write there, snapshot the "
                         "index, and WARM-RESTART from the latest snapshot "
                         "+ WAL tail when one exists")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot (and truncate the WAL) every N query "
                         "batches; 0 = only the boot snapshot")
    ap.add_argument("--pipelined", action="store_true",
                    help="serve through AsyncLSHService: pipelined query "
                         "batches + background snapshots "
                         "(bitwise-identical results)")
    args = ap.parse_args(argv)

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
    svc, rr = RetrievalService.recover_or_build(
        cfg, model, doc_tokens, snapshot_dir=args.snapshot_dir,
        n_shards=N_SHARDS, device=dev, bucket_size=bucket, r=0.2, L=args.L,
        k=8, W=0.5, scheme=Scheme(args.scheme), seed=args.seed,
        n_tables=args.tables, pipelined=args.pipelined)
    if rr is not None:
        # warm restart: snapshot + WAL tail instead of re-embed + rebuild
        print(f"[serve] WARM restart from {args.snapshot_dir} "
              f"(step {rr.step}, {rr.index.n_live} rows, "
              f"{rr.replayed_inserts + rr.replayed_deletes} WAL batches "
              f"replayed) in {time.monotonic() - t0:.1f}s")
    else:
        load = svc.index.shard_load
        print(f"[serve] {cfg.name} on {dev}: built index: {args.docs} "
              f"docs, {time.monotonic() - t0:.1f}s, "
              f"load max/avg={load.max() / max(load.mean(), 1):.1f}, "
              f"drops={svc.index.build_result.drops}")
        if args.snapshot_dir:
            print(f"[serve] boot snapshot -> {args.snapshot_dir}")

    lat = []
    for b in range(args.batches):
        kq = prng.fold_in(prng.PRNGKey(2), b)
        src = prng.randint(kq, (args.batch_size,), 0, args.docs).numpy()
        t0 = time.monotonic()
        svc.query(doc_tokens[src])
        lat.append(time.monotonic() - t0)
        if (args.snapshot_dir and args.snapshot_every
                and (b + 1) % args.snapshot_every == 0):
            if args.pipelined:
                # background snapshot: the engine thread fetches a
                # consistent point, a writer thread does the file I/O
                svc.service.snapshot(args.snapshot_dir).result()
            else:
                persist.snapshot(svc.index, args.snapshot_dir,
                                 wal=svc.service.wal)
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
