"""Wrapper of the hand-written CUDA p-stable hash kernel.

``lsh_hash_cuda`` launches ``csrc/lsh_hash.cu`` (built on first use) on
CUDA tensors or raises; on CPU tensors it runs the kernel's plain
version, ``ref.lsh_hash_ref``.  It counts its kernel launches in
``launches``.  Both compute hash_h's arithmetic bit for bit: every
product rounded once, the products summed in ``tree_sum``'s pairwise
order, then ``+ b``, ``/ w`` (a division, where the TPU kernel multiplies
by 1/w) and a floor.  So the index hashes through it: the insert, the
query dispatch, the receive side and the second layer ``G``
(``core/hashing.py``).

``plan`` sizes a launch in pure Python -- the chunk of products summed
in registers, the tiles, the ring of stages in shared memory -- as the
kernel lays it out, and raises on what the kernel does not take.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref

ROWS = 2               # rows a thread sums where one chunk is the dot
MAX_COLS = 8           # output columns a thread sums
COLS = (1, 2, 4, 5, 8)   # ... as the kernel is instantiated
MAX_CHUNK_LOG = 6      # at most 64 products summed in registers
LEVELS = 16            # d / chunk < 2**16 chunk sums a dot
MAX_STAGE = 64         # columns of d a stage holds (or one chunk)
SMEM_TWO = 113 * 1024  # two blocks an SM fit below this
SMEM_LIMIT = 232_448   # shared memory a block may have on Hopper
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("lsh_hash")
    if not getattr(lib, "_typed", False):
        lib.lsh_hash_launch.argtypes = (
            [_P] * 5 + [_I, _I, _LL, _I, _I, _I, _LL, ctypes.c_float, _LL,
                        _LL] + [_I] * 12 + [_LL, _P])
        lib.lsh_hash_launch.restype = _I
        lib._typed = True
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _round4(v: int) -> int:
    return (v + 3) & ~3


class Plan(NamedTuple):
    """How one call runs, as ``csrc/lsh_hash.cu`` lays it out: a block of
    8 warps sums a tile of ``rows`` rows against ``col_block``
    output columns, ROWS rows a thread (one where the dot takes several
    chunks), in ``col_groups`` groups of ``cols`` columns (one group a
    warp)."""
    chunk: int         # products a thread sums in registers (power of 2)
    chunks: int        # d / chunk chunk sums a dot
    stage_chunks: int  # chunks a stage holds (its d columns: their sum)
    col_block: int     # KB: output columns a block holds
    col_blocks: int    # ceil(K / KB)
    col_groups: int    # NG: warps side by side over the column block
    cols: int          # columns a thread sums, the least of COLS >= KB / NG
    rows: int          # 32 x (ROWS, or 1) x (8 / NG)
    pitch: int         # floats between two staged x rows
    apitch: int        # ... and two staged columns of a
    opitch: int        # ints between two staged output rows
    stages: int        # ring depth, 2 or 3
    a_resident: bool   # a staged once (one stage covers d and K)
    vec: bool          # x staged by 16-byte cp.async
    smem_bytes: int


def smem_bytes(T: int, K: int, KB: int, rows: int, pitch: int, apitch: int,
               opitch: int, stages: int, a_resident: bool,
               ids: bool) -> int:
    """The kernel's dynamic shared memory: b whole, a's stage(s), the x
    ring, the tile's outputs and, where rows carry table ids, each staged
    row's id."""
    return 4 * (_round4(T * K)
                + _round4(T * KB * apitch) * (1 if a_resident else stages)
                + _round4(rows * pitch) * stages + rows * opitch
                + (rows * stages if ids else 0))


def _pitch(ds: int, chunk: int) -> int:
    """Floats between staged rows of ds values: 4 (mod 8) where they are
    read 16 bytes at a time (a quarter warp's rows then cover all 32
    banks), else odd."""
    if chunk >= 4:
        return ds + 4 if (ds // 4) % 2 == 0 else ds + 8
    return ds | 1


def plan(n: int, d: int, K: int, *, T: int = 1,
         dtype: torch.dtype = torch.float32, vec: bool = False,
         table_ids: bool = False) -> Plan:
    """Sizing of a call: x (n, d) of ``dtype`` against T tables of a
    (d, K), rows under table ids where ``table_ids`` (or T > 1).  ``vec``
    says x could be staged by 16-byte copies (float32, contiguous rows,
    16-byte-aligned rows); it is kept where the chunk is a multiple of 4.
    A block takes up to 64 output columns, in the fewest warp-wide groups
    (1, 2, 4 or 8) of at most 8.  The chunk is 2**min(j, 6) for d = m
    2**j with m odd and a stage holds the most whole chunks that divide
    d / chunk within 64 columns.  While the stages do not fit, more
    groups (fewer rows), then fewer chunks a stage, then a smaller chunk
    are tried; the ring takes 3 stages where they fit in two blocks'
    share of an SM, else 2."""
    _need(dtype in DTYPES,
          f"x must be float32 or bfloat16 or int32, got {dtype}")
    _need(n >= 0 and d > 0 and K > 0 and T > 0,
          f"need n >= 0 and positive d, K, T (got {n}, {d}, {K}, {T})")
    p = _layout(d, K, T, dtype, bool(vec), T > 1 or bool(table_ids))
    _need(-(-n // p.rows) * p.col_blocks < 2 ** 31,
          f"n = {n} rows of K = {K} make too many tiles")
    return p


@functools.lru_cache(maxsize=256)
def _layout(d: int, K: int, T: int, dtype: torch.dtype, vec: bool,
            ids: bool) -> Plan:
    """plan()'s search, which does not depend on n (the serving path asks
    for the same few layouts on every bucket)."""
    KB = min(K, MAX_COLS * 8)
    col_blocks = -(-K // KB)
    opitch = KB | 1
    j = (d & -d).bit_length() - 1
    _need(d >> min(j, MAX_CHUNK_LOG) < 2 ** LEVELS,
          f"d = {d} needs {d >> min(j, MAX_CHUNK_LOG)} chunk sums a dot; "
          f"the kernel keeps fewer than {2 ** LEVELS}")
    groups = [g for g in (1, 2, 4, 8)
              if -(-KB // g) <= MAX_COLS and (g <= KB or g == 1)]
    cols = {g: min(c for c in COLS if c * g >= KB) for g in groups}
    for budget in (SMEM_TWO, SMEM_LIMIT):
        for log in range(min(j, MAX_CHUNK_LOG), -1, -1):
            chunk = 1 << log
            chunks = d // chunk
            if chunks >= 2 ** LEVELS:
                break
            for NG in groups:
                rows = 32 * (ROWS if chunks == 1 else 1) * (8 // NG)
                for sc in range(max(1, MAX_STAGE // chunk), 0, -1):
                    if chunks % sc:
                        continue
                    pitch = _pitch(sc * chunk, chunk)
                    a_res = chunks == sc and col_blocks == 1
                    for stages in (3, 2):
                        smem = smem_bytes(T, K, KB, rows, pitch, pitch,
                                          opitch, stages, a_res, ids)
                        if smem <= budget:
                            return Plan(
                                chunk, chunks, sc, KB, col_blocks, NG,
                                cols[NG], rows, pitch, pitch, opitch,
                                stages, a_res,
                                bool(vec and dtype == torch.float32
                                     and chunk % 4 == 0), smem)
    raise ValueError(f"T = {T} tables of K = {K} columns do not fit the "
                     f"kernel's shared memory ({SMEM_LIMIT} bytes)")


def _tables(x, a, b, table):
    """(T, rows per table entry) of a call, after checking the shapes.
    a (d, K) and b (K,): one table.  a (T, d, K) and b (T, K): row
    ``i`` of x's rows under ``table.flatten()[i // div]`` where table
    covers x's leading dims, or, with no table, under x's leading index
    (x (T, ..., d))."""
    _need(x.dim() >= 1, "x must be (..., d)")
    d = x.shape[-1]
    n = math.prod(x.shape[:-1])
    if a.dim() == 2:
        _need(b.dim() == 1, "a (d, K) needs b (K,)")
        _need(table is None, "a table id needs stacked a (T, d, K)")
        T = 1
    else:
        _need(a.dim() == 3 and b.dim() == 2,
              "a must be (d, K) or (T, d, K), b (K,) or (T, K)")
        T = a.shape[0]
        _need(b.shape[0] == T, f"b {tuple(b.shape)} does not match a "
                               f"{tuple(a.shape)}")
    _need(a.shape[-2] == d and b.shape[-1] == a.shape[-1],
          f"a {tuple(a.shape)} and b {tuple(b.shape)} do not match x "
          f"{tuple(x.shape)}")
    if table is not None:
        _need(table.dim() < x.dim()
              and tuple(table.shape) == tuple(x.shape[:table.dim()]),
              f"table {tuple(table.shape)} must cover x's leading dims "
              f"{tuple(x.shape[:-1])}")
        _need(not table.is_floating_point(), "table ids must be integers")
        entries = table.numel()
    elif a.dim() == 3:
        _need(x.dim() >= 2 and x.shape[0] == T,
              f"x {tuple(x.shape)} must lead with the T = {T} tables")
        entries = T
    else:
        entries = 1
    return T, max(1, n // max(1, entries))


def lsh_hash_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                  w: float, table: Optional[torch.Tensor] = None,
                  floor: bool = True) -> torch.Tensor:
    """floor((x a + b) / w) as int32, in hash_h's arithmetic, shape
    x.shape[:-1] + (K,): x (..., d) float32, bfloat16 or int32; a (d, K)
    and b (K,), or T stacked tables a (T, d, K) and b (T, K) with each
    row's table from ``table`` (integer ids in [0, T) covering x's
    leading dims; on the card a row with another id gets INT_MIN) or
    from x's leading axis (x (T, ..., d)).  ``floor=False``
    gives the float32 quotient.  Any n, d and K."""
    _need(x.dtype in DTYPES,
          f"x must be float32 or bfloat16 or int32, got {x.dtype}")
    _need(a.dtype == b.dtype == torch.float32, "a and b must be float32")
    _need(w > 0, f"w must be positive, got {w}")
    T, div = _tables(x, a, b, table)
    if not x.is_cuda:
        return ref.lsh_hash_ref(x, a, b, w=w, table=table, floor=floor)
    _need(all(t.device == x.device for t in (a, b))
          and (table is None or table.device == x.device),
          "x, a, b and table must be on one CUDA device")
    d, K = a.shape[-2:]
    lead = x.shape[:-1]
    out = torch.empty(lead + (K,), device=x.device,
                      dtype=torch.int32 if floor else torch.float32)
    n = out.numel() // K
    if n == 0:
        return out
    x2 = x.reshape(n, d)
    a, b = a.contiguous(), b.contiguous()
    if table is not None:
        table = table.to(torch.int32).contiguous()
    xs0, xs1 = x2.stride()
    p = plan(n, d, K, T=T, dtype=x.dtype,
             vec=(x.dtype == torch.float32 and xs1 == 1 and xs0 % 4 == 0
                  and x2.data_ptr() % 16 == 0), table_ids=table is not None)
    err = _lib().lsh_hash_launch(
        x2.data_ptr(), a.data_ptr(), b.data_ptr(),
        None if table is None else table.data_ptr(), out.data_ptr(),
        DTYPES[x.dtype], int(floor), n, d, K, T, div, float(w), xs0, xs1,
        p.chunk, p.stage_chunks, p.col_block, p.col_groups, p.cols, p.rows,
        p.stages, p.pitch, p.apitch, p.opitch, int(p.a_resident),
        int(p.vec), p.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lsh_hash launch failed: CUDA error {err}")
    lsh_hash_cuda.launches += 1
    return out


lsh_hash_cuda.launches = 0
