"""End-to-end streaming serving driver on the PyTorch port (the paper's
workload, with the LM zoo as the feature extractor), as
``examples/serve_retrieval.py`` is on the JAX package: embed documents
with a reduced-config LM, build the distributed Layered-LSH index over a
*prefix* of the corpus, then serve a mixed insert/query stream through
``ShardedLSHService`` -- new documents are routed into the per-shard
append regions while queries micro-batch through embed -> entropy
offsets -> Layered route -> per-shard bucket search.

  PYTHONPATH=src python examples/serve_retrieval_torch.py [--arch gemma-7b]
  PYTHONPATH=src python examples/serve_retrieval_torch.py --device cpu \\
      --arch mamba2-130m --docs 512 --steps 2 --batch-size 64 \\
      --insert-size 64

The flags and defaults are the reference driver's, with ``--device``
(the card unless given).  The weights are drawn from a torch.Generator
seeded 0, as the reference draws them from ``PRNGKey(0)``.
The corpus, each step's query sources, perturbed positions and new
tokens are the reference's draws bit for bit (the port's threefry
``prng``: ``PRNGKey(1)``, ``fold_in(PRNGKey(2), b)``, ``randint``).
With ``--snapshot-dir`` the service is durable, and a second run on the
same directory is a warm restart that resumes the stream where the
first left it; ``--pipelined`` serves through ``AsyncLSHService`` and
snapshots through it in the background.
"""
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

# logical shards on the one device (the reference runs one per device of
# an 8-device mesh)
N_SHARDS = 8
DOC_LEN = 32


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--device", default=None, help="cuda unless given")
    ap.add_argument("--docs", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--insert-size", type=int, default=128)
    ap.add_argument("--k-neighbors", type=int, default=5,
                    help="top-K results returned per query")
    ap.add_argument("--tables", type=int, default=1,
                    help="fused hash tables (union recall lever; the "
                         "exchange count per step does not change)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="durability: WAL every insert, snapshot "
                         "periodically, warm-restart from the latest "
                         "snapshot + WAL tail on reboot")
    ap.add_argument("--snapshot-every", type=int, default=2,
                    help="snapshot (and truncate the WAL) every N serve "
                         "steps (with --snapshot-dir)")
    ap.add_argument("--pipelined", action="store_true",
                    help="serve through AsyncLSHService: pipelined query "
                         "batches, an engine thread and background "
                         "snapshots (bitwise-identical results)")
    return ap.parse_args(argv)


def corpus(args, vocab: int) -> torch.Tensor:
    """The synthetic documents, (docs + steps * insert_size, 32) int32 on
    the host, drawn as ONE tensor.  Its counters run in row-major order,
    so a run with more --steps (and the same --docs and --insert-size)
    draws the same documents first: a warm restart with more steps
    continues the same stream."""
    n_total = args.docs + args.steps * args.insert_size
    return prng.randint(prng.PRNGKey(1), (n_total, DOC_LEN), 0, vocab)


def queries(doc_tokens: torch.Tensor, b: int, batch_size: int,
            n_indexed: int, vocab: int):
    """Step b's query mix: near-duplicates of indexed documents, one token
    of each replaced.  Returns (sources (batch,), tokens (batch, 32))."""
    kq = prng.fold_in(prng.PRNGKey(2), b)
    src = prng.randint(kq, (batch_size,), 0, n_indexed)
    pos = prng.randint(kq, (batch_size, 1), 0, DOC_LEN)
    newtok = prng.randint(kq, (batch_size, 1), 0, vocab)
    qtok = doc_tokens[src.to(torch.int64)].clone()
    qtok[torch.arange(batch_size), pos[:, 0].to(torch.int64)] = newtok[:, 0]
    return src, qtok


def serve(args, cfg, model) -> dict:
    """The driver's flow on ``model``; returns what it served: the warm
    restart (or None), the rows the index held before the stream, the
    step it resumed at, and each step's sources, query tokens, new gids,
    answers, rows a query and times."""
    dev = resolve_device(args.device)
    doc_tokens = corpus(args, cfg.vocab)

    t0 = time.monotonic()
    svc, rr = RetrievalService.recover_or_build(
        cfg, model, doc_tokens[:args.docs], snapshot_dir=args.snapshot_dir,
        n_shards=N_SHARDS, device=dev, bucket_size=args.batch_size,
        k_neighbors=args.k_neighbors, r=0.2, L=16, k=8, W=0.5,
        scheme=Scheme.LAYERED, n_tables=args.tables,
        pipelined=args.pipelined)
    t_build = time.monotonic() - t0
    if rr is not None:
        print(f"[build] WARM restart: snapshot step {rr.step} + "
              f"{rr.replayed_inserts + rr.replayed_deletes} WAL batches "
              f"({rr.index.n_live} rows) in {t_build:.1f}s")
    else:
        print(f"[build] indexed {args.docs} docs in {t_build:.1f}s "
              f"(data load max={svc.index.build_result.data_load.max()})")
        if args.snapshot_dir:
            print(f"[build] boot snapshot -> {args.snapshot_dir}")

    hits, steps = 0, []
    # resume the stream where the restored index left off: a warm restart
    # already holds the docs streamed before the crash, so re-running the
    # insert steps from 0 would store each of them again under new gids
    n_live = svc.index.n_live
    n_restored = n_live // svc.index.cfg.n_tables
    b0 = min(max(0, (n_restored - args.docs) // args.insert_size),
             args.steps)
    if b0:
        print(f"[serve] resuming stream at step {b0} "
              f"({n_restored} docs already indexed)")
    n_indexed = max(args.docs, n_restored)
    for b in range(b0, args.steps):
        # ---- streaming insert: the corpus grows while we serve ----
        t0 = time.monotonic()
        lo = args.docs + b * args.insert_size
        new_gids = svc.insert_docs(doc_tokens[lo:lo + args.insert_size])
        n_indexed += len(new_gids)
        if (args.snapshot_dir and args.snapshot_every
                and (b + 1) % args.snapshot_every == 0):
            if args.pipelined:
                # non-blocking durability: the engine fetches a
                # consistent point, a writer thread does the file I/O
                # while the stream keeps serving
                svc.service.snapshot(args.snapshot_dir).result()
            else:
                persist.snapshot(svc.index, args.snapshot_dir,
                                 wal=svc.service.wal)
        t_insert = time.monotonic() - t0

        # ---- query mix: near-duplicates of docs indexed so far ----
        src, qtok = queries(doc_tokens, b, args.batch_size, n_indexed,
                            cfg.vocab)
        t0 = time.monotonic()
        gids, dists, handles = svc.query(qtok)          # (b, K) each
        dt = time.monotonic() - t0
        src_np = src.numpy()
        batch_hits = int((gids[:, 0] == src_np).sum())
        topk_hits = int((gids == src_np[:, None]).any(axis=1).sum())
        hits += batch_hits
        fq = np.asarray([h.fq for h in handles])
        load = svc.service.shard_load()
        print(f"[serve] step {b}: +{len(new_gids)} docs, "
              f"{args.batch_size} queries in {dt:.2f}s "
              f"rows/query={fq.mean():.2f} "
              f"self-retrieval={batch_hits}/{args.batch_size} "
              f"(in top-{args.k_neighbors}: {topk_hits}) "
              f"load max/avg={load.max() / max(load.mean(), 1):.2f}")
        steps.append(dict(step=b, src=src_np, qtok=qtok.numpy(),
                          new_gids=new_gids, gids=gids, dists=dists, fq=fq,
                          batch_hits=batch_hits, topk_hits=topk_hits,
                          insert_s=t_insert, query_s=dt))

    svc.close()
    st = svc.service.stats
    n = max((args.steps - b0) * args.batch_size, 1)
    print(f"[serve] total: self-retrieval {hits}/{n} ({hits / n:.1%}), "
          f"avg rows/query {st.routed_rows / max(st.queries, 1):.2f} "
          f"(vs L=16 for simple LSH)")
    print(f"[serve] {st.summary()}")
    if st.drops:
        raise AssertionError(
            f"capacity overflow in the serving stream: {st.drops} drops")
    return dict(warm=rr, rows_at_start=n_live, resumed_at=b0,
                build_s=t_build, steps=steps, hits=hits, drops=st.drops)


def main(argv=None) -> dict:
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, generator=gen, device=dev)
    return serve(args, cfg, model)


if __name__ == "__main__":
    main()
