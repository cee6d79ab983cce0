"""Wrappers of the hand-written CUDA bucket-search kernels.

``bucket_search_cuda`` (the full scan) and ``bucket_gather_cuda`` (the
CSR gather) take tensors with a leading shard axis, so one launch
covers all S shards.  On a CUDA tensor a wrapper launches its kernel
(``csrc/bucket_search.cu``, built on first use) or raises; on a CPU
tensor it runs the kernel's plain version from ``ref.py``.  Each wrapper
counts its kernel launches in ``launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.types import QueryBatch, StoreView

MAX_SPLITS = 512      # point-axis splits of the full scan
MIN_SPLIT = 4096      # fewest points a split is given
PART_KEYS = 1 << 26   # most partial top-K keys the splits may hold
SMEM_LIMIT = 232448   # dynamic shared memory one H100 block may use
STAGE_N = 128         # points the full scan stages per barrier

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("bucket_search")
    if not getattr(lib, "_typed", False):
        lib.bucket_search_launch.argtypes = (
            [_P] * 7 + [_I] * 5 + [_P] * 6 + [_LL] * 3 + [_I, _I, _F]
            + [_P] * 5 + [_P])
        lib.bucket_search_launch.restype = _I
        lib.bucket_gather_launch.argtypes = (
            [_P] * 4 + [_I] * 4 + [_P] * 4 + [_LL] * 2 + [_F]
            + [_P] * 3 + [_P])
        lib.bucket_gather_launch.restype = _I
        lib._typed = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _rows_ok(t: torch.Tensor, dtype, name: str) -> int:
    """Check a (S, N, ...) store column: dtype, on the card, each shard's
    rows contiguous; returns its shard stride in elements."""
    _need(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _need(t.is_cuda, f"{name} must be a CUDA tensor")
    inner = 1
    for dim in range(t.dim() - 1, 0, -1):
        _need(t.shape[dim] == 1 or t.stride(dim) == inner,
              f"{name}: each shard's rows must be contiguous")
        inner *= t.shape[dim]
    return t.stride(0)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def n_splits_for(n_points: int, n_rows: int) -> int:
    """Point-axis splits of the full scan: a routed buffer holds a few
    dozen live rows per shard, one partial row tile, so the point axis is
    what fills the card; each split gets at least MIN_SPLIT points, and
    the splits' partial lists stay within PART_KEYS keys."""
    return max(1, min(MAX_SPLITS, -(-n_points // MIN_SPLIT),
                      PART_KEYS // max(n_rows, 1)))


def bucket_search_cuda(*, query: QueryBatch, store: StoreView, cr2: float,
                       L: int, K: int = 1):
    """Masked top-K full scan over every stored row (see
    ``ref.bucket_search_ref`` for the contract).

    query tensors (S, R, ...), store tensors (S, N, ...).  Returns
    (topd (S, R, K) f32, topg (S, R, K) int32, cnt (S, R) int32).
    """
    if not query.q.is_cuda:
        return ref.bucket_search_ref(query=query, store=store, cr2=cr2,
                                     L=L, K=K)
    S, R, d = query.q.shape
    N = store.points.shape[1]
    dev = query.q.device
    _need(1 <= K <= 128, f"K={K} not in [1, 128]")
    _need(query.buckets.shape == (S, R, 2 * L), "buckets must be (S, R, 2L)")
    q = query.q.contiguous()
    qsq = query.qsq.contiguous()
    qb = query.buckets.contiguous()
    probe = query.probe.contiguous()
    qtab = query.table.contiguous()
    for name, t, dt in (("q", q, torch.float32), ("qsq", qsq, torch.float32),
                        ("buckets", qb, torch.int32),
                        ("probe", probe, torch.int32),
                        ("table", qtab, torch.int32)):
        _need(t.dtype == dt and t.is_cuda, f"query.{name}: {dt} on the card")
    sp = _rows_ok(store.points, torch.float32, "points")
    sn = _rows_ok(store.psq, torch.float32, "psq")
    for name in ("gid", "valid", "table"):
        _need(_rows_ok(getattr(store, name), torch.int32, name) == sn,
              f"store.{name} must share psq's shard stride")
    sb = _rows_ok(store.buckets, torch.int32, "store buckets")
    dp = -(-d // 16) * 16
    _need(STAGE_N * dp * 4 + 6 * STAGE_N * 4 + K * 128 * 8 <= SMEM_LIMIT,
          f"d={d}, K={K}: the staged tile does not fit in shared memory")

    # rows that probe no bucket have no hit: list the live rows first
    live = (probe > 0).any(dim=-1)
    row_idx = torch.argsort(live.to(torch.int8), dim=-1, descending=True,
                            stable=True).to(torch.int32)
    nlive = live.sum(dim=-1, dtype=torch.int32)
    n_splits = n_splits_for(N, S * R * K)
    part_keys = torch.empty((S, R, n_splits, K), dtype=torch.int64,
                            device=dev)
    part_cnt = torch.empty((S, R, n_splits), dtype=torch.int32, device=dev)
    topd = torch.full((S, R, K), ref.F32_MAX, dtype=torch.float32,
                      device=dev)
    topg = torch.full((S, R, K), ref.IMAX, dtype=torch.int32, device=dev)
    cnt = torch.zeros((S, R), dtype=torch.int32, device=dev)
    if R == 0 or N == 0:
        return topd, topg, cnt
    err = _lib().bucket_search_launch(
        _ptr(q), _ptr(qsq), _ptr(qb), _ptr(probe), _ptr(qtab),
        _ptr(row_idx), _ptr(nlive), S, R, d, L, K,
        _ptr(store.points), _ptr(store.psq), _ptr(store.buckets),
        _ptr(store.gid), _ptr(store.valid), _ptr(store.table),
        sp, sn, sb, N, n_splits, float(cr2),
        _ptr(part_keys), _ptr(part_cnt), _ptr(topd), _ptr(topg), _ptr(cnt),
        _stream())
    _check(err, "bucket_search")
    bucket_search_cuda.launches += 1
    return topd, topg, cnt


bucket_search_cuda.launches = 0


def bucket_gather_cuda(q, qsq, start, end, p, psq, gid, pvalid,
                       cr2: float, *, K: int):
    """CSR gather over a bucket-sorted region (see ``ref.bucket_gather_ref``
    for the contract).

    q (S, E, d) expanded (query row, probe) rows, qsq/start/end (S, E);
    p (S, N, d) and psq/gid/pvalid (S, N) the sorted region.  Returns
    (topd (S, E, K), topg (S, E, K), cnt (S, E)).
    """
    if not q.is_cuda:
        return ref.bucket_gather_ref(q, qsq, start, end, p, psq, gid,
                                     pvalid, cr2, K=K)
    S, E, d = q.shape
    dev = q.device
    _need(1 <= K <= 128, f"K={K} not in [1, 128]")
    q, qsq = q.contiguous(), qsq.contiguous()
    start, end = start.contiguous(), end.contiguous()
    for name, t, dt in (("q", q, torch.float32), ("qsq", qsq, torch.float32),
                        ("start", start, torch.int32),
                        ("end", end, torch.int32)):
        _need(t.dtype == dt and t.is_cuda, f"{name}: {dt} on the card")
    sp = _rows_ok(p, torch.float32, "p")
    sn = _rows_ok(psq, torch.float32, "psq")
    _need(_rows_ok(gid, torch.int32, "gid") == sn
          and _rows_ok(pvalid, torch.int32, "pvalid") == sn,
          "gid/pvalid must share psq's shard stride")
    topd = torch.empty((S, E, K), dtype=torch.float32, device=dev)
    topg = torch.empty((S, E, K), dtype=torch.int32, device=dev)
    cnt = torch.empty((S, E), dtype=torch.int32, device=dev)
    if E == 0:
        return topd, topg, cnt
    err = _lib().bucket_gather_launch(
        _ptr(q), _ptr(qsq), _ptr(start), _ptr(end), S, E, d, K, _ptr(p),
        _ptr(psq), _ptr(gid), _ptr(pvalid), sp, sn, float(cr2), _ptr(topd),
        _ptr(topg), _ptr(cnt), _stream())
    _check(err, "bucket_gather")
    bucket_gather_cuda.launches += 1
    return topd, topg, cnt


bucket_gather_cuda.launches = 0
