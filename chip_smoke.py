#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the root of the repository:  python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
builds the Layered-LSH index over 2**22 planted points (d = 64, 8 shards,
2 tables: the configuration of ``benchmarks/bench_serving.py``), serves
query buckets through ``ShardedLSHService`` on the unsorted store (full-
scan kernel), again after ``compact()`` (CSR gather kernel; the answers
must be bitwise equal), and again after a streaming insert of 2**16
points and a delete of 1024 (gather plus tail scan).  Then it holds each
kernel against its plain PyTorch version on the inputs the path gave it,
times both with CUDA events, traces one serving bucket with
torch.profiler, and prints one JSON line of kernel records and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises:
the exit code is then non-zero and the last line is not printed.  With
no CUDA device it exits with code 2 before doing anything.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
IMAX = 2 ** 31 - 1
BUCKETS = 4        # query buckets served per phase
REPS = 5           # timed kernel runs


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    """One nvcc per CUDA source, all started together."""
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        outs = list(pool.map(
            lambda n: _build.compile_source(n, ["-Xptxas", "-v"]), names))
    for name, (path, log) in zip(names, outs):
        print(f"built {name}: {path.name}")
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print("  " + line.strip())
    return names


def timed(fn, reps):
    """Mean device time of fn() in ms over reps runs (after one warm-up),
    with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def compare(name, got, want):
    """Integers equal, distances within rtol = atol = 1e-5."""
    import torch
    gd, gg, gc = (t.cpu() for t in got)
    wd, wg, wc = (t.cpu() for t in want)
    check(torch.equal(gg, wg), f"{name}: gids differ from the plain version")
    check(torch.equal(gc, wc), f"{name}: counts differ from the plain version")
    check(torch.allclose(gd, wd, rtol=1e-5, atol=1e-5),
          f"{name}: distances differ from the plain version")
    return float((gd.double() - wd.double()).abs().max())


def serve(svc, queries):
    """Answer every query through the service; returns (gids, dist bits,
    counts) and the mean host time of one bucket (ends in a sync: the
    answers are on the host)."""
    import numpy as np
    t0, b0 = svc.stats.query_time_s, svc.stats.batches
    handles = svc.submit_batch(queries)
    svc.drain()
    check(all(h.done for h in handles), "unanswered queries")
    gids = np.stack([h.gids for h in handles])
    dists = np.stack([h.dists for h in handles]).astype(np.float32)
    emit = np.array([h.n_within_cr for h in handles])
    per_bucket = (svc.stats.query_time_s - t0) / (svc.stats.batches - b0)
    return gids, dists, emit, per_bucket * 1e3


def profile_bucket(svc, queries):
    """Trace one serving bucket: device time by kernel, the number of
    device launches, and the device's busy share of the bucket's wall
    time (kernel times summed, so overlap would count twice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    serve(svc, queries)                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(svc, queries)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    print(f"profile: one bucket {wall:.2f} ms wall, device busy {busy:.2f} "
          f"ms ({100 * busy / wall:.1f}%), {launches} device ops")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-n", type=int, default=22,
                    help="log2 of the number of stored points")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme
    from repro_torch.kernels import bucket_search as kbs
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import ShardedLSHService

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    dev_name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {dev_name} x{count}")

    # ---- phase 2: build the kernels --------------------------------------
    t0 = time.perf_counter()
    build_kernels()
    print(f"phase build_kernels: {time.perf_counter() - t0:.1f} s")

    # ---- data: planted points N(0, 1/d), queries = point + r/sqrt(d) noise
    cfg = LSHConfig(d=64, k=10, W=1.0, r=0.3, c=2.0, L=16, n_shards=8,
                    scheme=Scheme.LAYERED, seed=0, n_tables=2)
    K, bucket = 10, 64
    n, d, m = 1 << args.log_n, cfg.d, BUCKETS * bucket
    rng = np.random.default_rng(args.seed)
    data = rng.standard_normal((n, d), dtype=np.float32)
    data *= np.float32(1.0 / math.sqrt(d))
    planted = rng.integers(0, n, m)
    noise = rng.standard_normal((m, d), dtype=np.float32)
    queries = data[planted] + noise * np.float32(cfg.r / math.sqrt(d))
    extra = rng.standard_normal((1 << 16, d), dtype=np.float32)
    extra *= np.float32(1.0 / math.sqrt(d))
    victims = rng.choice(n, 1024, replace=False)

    # record each kernel's first inputs on the path, for the comparison
    captured = {}

    def recorder(name, fn):
        def wrapped(*a, **kw):
            captured.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return wrapped
    ops.bucket_search_cuda = recorder("bucket_search", kbs.bucket_search_cuda)
    ops.bucket_gather_cuda = recorder("bucket_gather", kbs.bucket_gather_cuda)

    # ---- the main path: counts to 0, drive, read ---------------------------
    kbs.bucket_search_cuda.launches = 0
    kbs.bucket_gather_cuda.launches = 0
    t0 = time.perf_counter()
    idx = DistributedLSHIndex(cfg, k_neighbors=K)
    calls = idx.a2a.calls
    idx.build(data)
    torch.cuda.synchronize()
    check(idx.a2a.calls == calls + 1, "insert must exchange once")
    check(idx.build_result.drops == 0, "build dropped rows")
    print(f"phase build_index: {time.perf_counter() - t0:.1f} s, "
          f"capacity {idx.store.capacity}/shard, "
          f"load {idx.shard_load.tolist()}")

    svc = ShardedLSHService(idx, bucket_size=bucket,
                            max_latency_ms=float("inf"), k_neighbors=K)
    calls = idx.a2a.calls
    g4, d4, e4, ms4 = serve(svc, queries)
    check(idx.a2a.calls == calls + 2 * BUCKETS,
          "a query must exchange twice")
    print(f"phase serve_unsorted: {BUCKETS} buckets, "
          f"{ms4:.2f} ms/bucket")

    t0 = time.perf_counter()
    idx.compact()
    torch.cuda.synchronize()
    print(f"phase compact: {time.perf_counter() - t0:.1f} s, "
          f"n_sorted {idx.store.n_sorted}, "
          f"max bucket {idx.layout['max_bucket']}")
    g5, d5, e5, ms5 = serve(svc, queries)
    check(np.array_equal(g4, g5) and np.array_equal(e4, e5)
          and np.array_equal(d4.view(np.uint32), d5.view(np.uint32)),
          "CSR answers are not bitwise equal to the full scan's")
    print(f"phase serve_sorted: bitwise equal, {ms5:.2f} ms/bucket")

    calls = idx.a2a.calls
    ins = svc.insert(extra, gids=np.arange(n, n + len(extra)))
    check(idx.a2a.calls == calls + 1 and ins.drops == 0,
          "streaming insert: one exchange, no drops")
    dele = svc.delete(victims)
    check(idx.a2a.calls == calls + 1, "delete must not exchange")
    check(dele.n_points == len(victims), "delete missed live gids")
    g6, d6, e6, ms6 = serve(svc, queries)
    print(f"phase serve_tail: tail {idx.layout['tail_rows']} rows, "
          f"{ms6:.2f} ms/bucket")
    torch.cuda.synchronize()
    launches = {"bucket_search": kbs.bucket_search_cuda.launches,
                "bucket_gather": kbs.bucket_gather_cuda.launches}
    print(f"launches on the main path: {launches}")

    # ---- checks on the answers ------------------------------------------
    check(svc.stats.drops == 0, "capacity drops in serving")
    check(launches["bucket_search"] > 0 and launches["bucket_gather"] > 0,
          "a kernel of the path never launched")
    for g, dd in ((g4, d4), (g6, d6)):
        check(g.shape == (m, K) and dd.shape == (m, K), "answer shape")
        hit = g != IMAX
        check(np.all(np.isfinite(dd[hit])) and np.all(np.isinf(dd[~hit])),
              "distances must be finite exactly where a gid is")
        check(np.all(dd[hit] <= cfg.c * cfg.r * (1 + 1e-5)),
              "answers must lie within cr")
    check(not np.isin(g6, victims).any(), "a deleted gid was returned")
    # brute-force distances of the returned pairs (float64 on the host)
    rows, cols = np.nonzero(g4 != IMAX)
    true = np.linalg.norm(queries[rows].astype(np.float64)
                          - data[g4[rows, cols]].astype(np.float64), axis=1)
    check(np.allclose(d4[rows, cols], true, rtol=1e-4, atol=1e-4),
          "returned distances disagree with brute force")
    recall = float(np.mean((g4 == planted[:, None]).any(axis=1)))
    print(f"planted-neighbour recall@{K}: {recall:.4f} "
          f"(found in {float(np.mean(g4[:, 0] != IMAX)):.4f} of queries)")

    # ---- each kernel against its plain version, at the path's inputs ------
    records = []
    _, kw = captured.pop("bucket_search")
    query, store = kw["query"], kw["store"]
    ms, got = timed(lambda: kbs.bucket_search_cuda(**kw), REPS)
    t_ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t_ev[0].record()
    want = ref.bucket_search_ref(**kw)
    t_ev[1].record()
    torch.cuda.synchronize()
    plain_ms = t_ev[0].elapsed_time(t_ev[1])
    err = compare("bucket_search", got, want)
    live_s = (query.probe > 0).any(dim=-1).sum(dim=-1)
    valid_s = (store.valid > 0).sum(dim=-1)
    live_rows, valid_pts = int(live_s.sum()), int(valid_s.sum())
    S, N = store.points.shape[0], store.points.shape[1]
    # the pairs this run's data needs: live rows x valid points per shard
    flops = 2.0 * float((live_s.double() * valid_s.double()).sum()) * d
    nbytes = (valid_pts * (d * 4 + 4 + 8 + 4 + 4 + 4)
              + live_rows * (d * 4 + 4 + 8 * cfg.L + 4 * cfg.L + 4)
              + query.q.shape[0] * query.q.shape[1] * (K * 8 + 4))
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    records.append({
        "name": "bucket_search", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bucket_search.cu",
        "replaces": "src/repro/kernels/bucket_search.py:168",
        "launches": launches["bucket_search"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if flops / PEAK_F32_FLOPS
        >= nbytes / PEAK_BYTES else "bytes", "library_ms": None})
    print(f"bucket_search: S={S} R={query.q.shape[1]} live rows "
          f"{live_rows} N={N} valid {valid_pts}: {ms:.3f} ms "
          f"(plain {plain_ms:.1f} ms, bound {bound:.3f} ms)")
    del kw, query, store, got, want

    a, kw = captured.pop("bucket_gather")
    ms, got = timed(lambda: kbs.bucket_gather_cuda(*a, **kw), REPS)
    t_ev[0].record()
    want = ref.bucket_gather_ref(*a, **kw)
    t_ev[1].record()
    torch.cuda.synchronize()
    plain_ms = t_ev[0].elapsed_time(t_ev[1])
    err = compare("bucket_gather", got, want)
    q, qsq, start, end = a[:4]
    span = (end - start).to(torch.int64)
    touched = int(span.sum())
    live_e = int((span > 0).sum())
    flops = 2.0 * touched * d
    nbytes = (touched * (d * 4 + 4 + 4 + 4) + live_e * (d * 4 + 12)
              + q.shape[0] * q.shape[1] * (K * 8 + 4))
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    records.append({
        "name": "bucket_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bucket_search.cu",
        "replaces": "src/repro/kernels/bucket_search.py:268",
        "launches": launches["bucket_gather"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if flops / PEAK_F32_FLOPS
        >= nbytes / PEAK_BYTES else "bytes", "library_ms": None})
    print(f"bucket_gather: S={q.shape[0]} E={q.shape[1]} live {live_e} "
          f"rows touched {touched}: {ms:.3f} ms (plain {plain_ms:.1f} ms, "
          f"bound {bound:.4f} ms)")
    profile_bucket(svc, queries[:bucket])
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB; total {time.perf_counter() - t_start:.0f} s")

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
