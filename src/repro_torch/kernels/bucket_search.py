"""Wrappers of the hand-written CUDA bucket-search kernels.

``bucket_search_cuda`` (the full scan) and ``bucket_gather_cuda`` (the
CSR gather) take tensors with a leading shard axis, so one launch
covers all S shards.  On a CUDA tensor a wrapper launches its kernel
(``csrc/bucket_search.cu``, built on first use) or raises; on a CPU
tensor it runs the kernel's plain version from ``ref.py``.  Each wrapper
counts its kernel launches in ``launches``.

The full scan matches first: a probe table per (shard, tile of TILE_R
live rows) -- key (table, hi, lo) -> mask of the tile's rows -- filters
the store's slots, and only matched (row, slot) pairs get a distance.
``scan_plan`` and ``gather_plan`` size both kernels in pure Python, as
the C side does (a card test compares them).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.types import QueryBatch, StoreView

SMEM_LIMIT = 232448    # dynamic shared memory one H100 block may use
TILE_R = 64            # rows of a tile: one bit of a probe-table mask
BLOCK = 512            # threads of a scan or gather block
SLOTS = 4              # slots a thread filters a step
CH = SLOTS * BLOCK     # slots one filter step covers
MQ = CH + BLOCK        # matched-slot queue entries of a scan block
HQ = BLOCK             # hit-queue entries, one a thread
NW, NMISC = BLOCK // 32, 8
MAX_K = 128
TARGET_BLOCKS = 1056   # scan blocks of live tiles to aim for: 8 an SM
MIN_SPLIT = 32         # fewest slots a split is given
MAX_SPLITS = 512       # point-axis splits of the full scan
PART_KEYS = 1 << 26    # most partial top-K keys the splits may hold

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("bucket_search")
    if not getattr(lib, "_typed", False):
        lib.bucket_search_launch.argtypes = (
            [_P] * 5 + [_I] * 5 + [_P] * 6 + [_LL] * 3 + [_I] * 4 + [_LL]
            + [_F, _P, _LL] + [_P] * 3 + [_P])
        lib.bucket_search_launch.restype = _I
        lib.bucket_gather_launch.argtypes = (
            [_P] * 4 + [_I] * 4 + [_P] * 4 + [_LL] * 2 + [_F, _LL]
            + [_P] * 3 + [_P])
        lib.bucket_gather_launch.restype = _I
        lib.bucket_search_smem_bytes.argtypes = [_I, _I, _I]
        lib.bucket_search_smem_bytes.restype = _LL
        lib.bucket_gather_smem_bytes.argtypes = [_I]
        lib.bucket_gather_smem_bytes.restype = _LL
        lib.bucket_search_workspace_bytes.argtypes = [_I] * 5
        lib.bucket_search_workspace_bytes.restype = _LL
        lib._typed = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


class ScanPlan(NamedTuple):
    """How one full-scan call runs, as ``csrc/bucket_search.cu`` sizes it;
    a probe table and a scan block cover TILE_R live rows (one mask word).
    """
    n_splits: int        # blocks the point axis is split over
    table_slots: int     # H: slots of one probe table (a power of two)
    table_in_smem: bool  # scan blocks copy their table into shared memory
    smem_bytes: int      # dynamic shared memory of a scan block
    workspace_bytes: int  # device scratch: partial lists, tables, rows


def scan_smem_bytes(K: int, H: int, table_in_smem: bool) -> int:
    """Shared bytes of a scan block: the tile's K-lists, the matched-slot
    and hit queues (8-byte masks and keys, 4-byte slots, prefixes, rows),
    the tile's row offsets, norms and counts, scan partials and counters,
    and, when copied in, the table: an 8-byte mask and three 4-byte key
    words a slot."""
    return (8 * (K * TILE_R + MQ + HQ) + (20 * H if table_in_smem else 0)
            + 4 * (2 * MQ + HQ + 3 * TILE_R + NW + NMISC))


@functools.lru_cache(maxsize=256)
def scan_plan(S: int, R: int, N: int, d: int, L: int, K: int) -> ScanPlan:
    """Plan the full scan of S shards of R query rows (L probes each) over
    N slots a shard at width d, keeping K neighbours a row.  Any d >= 1
    gives the same layout: query and point rows are read from global
    memory, one pair at a time.

    A probe table holds at most TILE_R * L keys in H >= 2 * TILE_R * L
    slots, so a lookup that misses stops at an empty slot within a few
    probes; blocks copy it into shared memory when it fits beside the
    lists and queues, else they probe it in global memory.  The point
    axis is split so that the live tiles' blocks number about
    TARGET_BLOCKS, each split at least MIN_SPLIT slots (a hot bucket in
    a small store spreads over blocks), and the partial lists stay
    within PART_KEYS keys.  Raises ValueError on a shape the kernel does
    not take."""
    _need(1 <= K <= MAX_K, f"K={K} not in [1, {MAX_K}]")
    _need(L >= 1 and d >= 1 and S >= 1 and R >= 0 and N >= 0,
          f"bad full-scan shape S={S} R={R} N={N} d={d} L={L}")
    H = 1 << (2 * TILE_R * L - 1).bit_length()
    in_smem = scan_smem_bytes(K, H, True) <= SMEM_LIMIT
    smem = scan_smem_bytes(K, H, in_smem)
    _need(smem <= SMEM_LIMIT, f"K={K}: {smem} bytes of shared memory")
    n_splits = max(1, min(MAX_SPLITS, -(-TARGET_BLOCKS // S),
                          -(-N // MIN_SPLIT),
                          PART_KEYS // max(S * R * K, 1)))
    tiles = -(-R // TILE_R)
    rows = S * R
    workspace = (8 * rows * n_splits * K + S * tiles * H * 24
                 + 4 * (rows * n_splits + rows + S))
    return ScanPlan(n_splits, H, in_smem, smem, workspace)


def gather_plan(K: int) -> int:
    """Dynamic shared bytes of a gather block keeping K neighbours a row:
    the K-lists and hit keys, 8-byte span prefixes and scan partials,
    4-byte row offsets, starts, norms, counts, hit rows and counters.
    Raises ValueError on a K the kernel does not take."""
    _need(1 <= K <= MAX_K, f"K={K} not in [1, {MAX_K}]")
    return (8 * (K * TILE_R + HQ + TILE_R + NW)
            + 4 * (4 * TILE_R + HQ + NMISC))


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
    _need(query.buckets.shape == (S, R, 2 * L), "buckets must be (S, R, 2L)")
    plan = scan_plan(S, R, N, d, L, K)
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
    _need(store.buckets.data_ptr() % 8 == 0 and sb % 2 == 0,
          "store buckets: each (hi, lo) pair must be 8-byte aligned")

    if R == 0 or N == 0:
        return (torch.full((S, R, K), ref.F32_MAX, device=dev),
                torch.full((S, R, K), ref.IMAX, dtype=torch.int32,
                           device=dev),
                torch.zeros((S, R), dtype=torch.int32, device=dev))
    # the kernels write every row: no fills on the host's way
    topd = torch.empty((S, R, K), dtype=torch.float32, device=dev)
    topg = torch.empty((S, R, K), dtype=torch.int32, device=dev)
    cnt = torch.empty((S, R), dtype=torch.int32, device=dev)
    ws = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=dev)
    err = _lib().bucket_search_launch(
        _ptr(q), _ptr(qsq), _ptr(qb), _ptr(probe), _ptr(qtab), S, R, d, L,
        K, _ptr(store.points), _ptr(store.psq), _ptr(store.buckets),
        _ptr(store.gid), _ptr(store.valid), _ptr(store.table),
        sp, sn, sb, N, plan.n_splits, plan.table_slots,
        int(plan.table_in_smem), plan.smem_bytes, float(cr2), _ptr(ws),
        plan.workspace_bytes, _ptr(topd), _ptr(topg), _ptr(cnt), _stream())
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
    smem = gather_plan(K)
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
        _ptr(psq), _ptr(gid), _ptr(pvalid), sp, sn, float(cr2), smem,
        _ptr(topd), _ptr(topg), _ptr(cnt), _stream())
    _check(err, "bucket_gather")
    bucket_gather_cuda.launches += 1
    return topd, topg, cnt


bucket_gather_cuda.launches = 0
