"""Wrapper of the hand-written CUDA SSD chunked-scan kernels (Mamba-2).

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu`` (built on first use) on
CUDA tensors or raises; on CPU tensors it runs the kernel's plain
version, ``ref.ssd_scan_ref`` (the sequential scan).  The source holds
two designs, and ``plan`` picks one from the dtype, the widths and the
alignment before the launch: "tensor_core" (bf16 on ``mma.sync``) or
"cuda_core" (float32 products).  The wrapper counts its launches in
``launches`` and, per design, in ``launches_by_design``.  Nothing is
padded or repeated: the kernels mask a ragged last chunk themselves and
read B and C at each head's group through their strides.

``ssd_scan_bwd_cuda`` is the scan's gradient: ``csrc/ssd_scan_bwd.cu``, the
port's own kernels (the reference differentiates its plain scan), on CUDA
tensors, ``ref.ssd_scan_bwd_ref`` on CPU tensors.  ``bwd_plan`` picks its
design by ``plan``'s rule -- "tensor_core" (the chunked backward on
``mma.sync``) or "cuda_core" (the reverse recurrence one step at a time,
in float32) -- and mirrors its shared memory and workspace; it counts its
calls in ``launches`` and ``launches_by_design``.

On meta tensors (the dry run's device, ``launch/dryrun.py``) both take
the card's route up to the launch -- the checks, ``plan`` or
``bwd_plan``, the outputs and workspace -- then report the launch to
``launch/op_cost.py`` with its cost instead of making it: no launch is
counted.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

CHUNK = 64             # steps a block takes at a time, in both designs
MAX_P = 128            # widest head the CUDA-core design takes
TC_MAX_P = 64          # ... and the tensor-core one (state in registers)
TC_MAX_N = 128
TC_THREADS = 128
CC_THREADS = 256
SMEM_LIMIT = 232_448   # shared memory a block may have on Hopper
DESIGNS = ("tensor_core", "cuda_core")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_launch.argtypes = [_P] * 6 + [_I] * 7 + [_LL] * 19 + [_P]
        lib.ssd_scan_launch.restype = _I
        lib.ssd_scan_tc_launch.argtypes = (
            [_P] * 6 + [_I] * 6 + [_LL] * 19 + [_P])
        lib.ssd_scan_tc_launch.restype = _I
        for fn in (lib.ssd_scan_smem_bytes, lib.ssd_scan_tc_smem_bytes):
            fn.argtypes = [_I, _I]
            fn.restype = _LL
        lib._typed = True
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


class Plan(NamedTuple):
    """How one call runs, as ``csrc/ssd_scan.cu`` sizes it."""
    design: str        # "tensor_core" or "cuda_core"
    chunk: int         # steps a block takes at a time
    threads: int       # threads a block
    smem_bytes: int    # dynamic shared memory a block needs


def tc_smem_bytes(P: int, N: int) -> int:
    """Shared bytes of a tensor-core block: two stages of bf16 x (Q, P +
    8), B and C (Q, N + 8) and f32 dt (Q,), the bf16 state copy (P,
    N + 8), and each of the 4 warps' cum and w (2, Q) f32."""
    stage = CHUNK * (P + 8) * 2 + 2 * CHUNK * (N + 8) * 2 + CHUNK * 4
    return 2 * stage + P * (N + 8) * 2 + TC_THREADS // 32 * 2 * CHUNK * 4


def cuda_core_smem_bytes(P: int, N: int) -> int:
    """Shared bytes of a CUDA-core block: float32 C (Q, N + 1), B^T in
    whole row blocks of Q (Q + 1 wide), x (Q, PP), M (Q, Q + 1), the state
    (N, PP) and four (Q,) columns, P padded to PP = 16, 32, 64 or 128."""
    pp = next(w for w in (16, 32, 64, 128) if P <= w)
    nrows = -(-N // CHUNK) * CHUNK
    floats = (CHUNK * (N + 1) + nrows * (CHUNK + 1) + CHUNK * pp
              + CHUNK * (CHUNK + 1) + N * pp + 4 * CHUNK)
    return (floats + 1) * 4


def _tensor_core(dtype, P, N, strides, aligned) -> bool:
    """bf16 with P and N multiples of 16, P <= 64, N <= 128, unit-stride
    rows and every other stride (``strides``: 4 a tensor) a whole number
    of 16-byte chunks, every pointer 16-byte aligned."""
    strides = tuple(strides)
    return (dtype == torch.bfloat16 and P % 16 == 0 and N % 16 == 0
            and P <= TC_MAX_P and N <= TC_MAX_N and aligned
            and all(s == 1 for s in strides[3::4])
            and all(s % 8 == 0 for i, s in enumerate(strides) if i % 4 < 3))


def plan(dtype: torch.dtype, P: int, N: int, *, strides=(),
         aligned: bool = True) -> Plan:
    """The design and sizing of a call at head width P and state width N.

    ``strides`` are the element strides of x, b, c and y (4 each),
    ``aligned`` whether their data pointers are 16-byte aligned.  bf16
    with P and N multiples of 16, P <= 64, N <= 128, unit-stride rows and
    every other stride a whole number of 16-byte chunks takes the
    tensor-core design; float32 (whose tolerance bf16 products could not
    meet) and any other input the CUDA-core one.  Raises ValueError for
    an input neither design takes."""
    _need(0 < P <= MAX_P, f"head width {P} must be in [1, {MAX_P}]")
    _need(N > 0, f"state width {N} must be positive")
    if _tensor_core(dtype, P, N, strides, aligned):
        p = Plan("tensor_core", CHUNK, TC_THREADS, tc_smem_bytes(P, N))
    else:
        p = Plan("cuda_core", CHUNK, CC_THREADS, cuda_core_smem_bytes(P, N))
    _need(p.smem_bytes <= SMEM_LIMIT, f"P={P}, N={N} need {p.smem_bytes} "
          f"bytes of shared memory, past the {SMEM_LIMIT} a block may have")
    return p


def ssd_scan_cuda(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD scan: x (B, S, H, P), b and c (B, S, G, N) with H a
    multiple of G (head h reads group h // (H // G)), dt (B, S, H) and
    a_log (H,) float32; x, b and c share float32 or bfloat16.  Returns y
    (B, S, H, P) in x's dtype.  Any S."""
    _need(x.dim() == 4 and b.dim() == 4 and c.shape == b.shape,
          "x must be (B, S, H, P) and b, c (B, S, G, N)")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    _need(b.shape[:2] == (B, S), f"b/c {tuple(b.shape)} do not match x "
          f"{tuple(x.shape)}")
    _need(G > 0 and H % G == 0, f"H={H} is not a multiple of G={G}")
    _need(dt.shape == (B, S, H), f"dt must be (B, S, H) = {(B, S, H)}, "
          f"got {tuple(dt.shape)}")
    _need(a_log.shape == (H,), f"a_log must be ({H},), got "
          f"{tuple(a_log.shape)}")
    _need(dt.dtype == torch.float32 and a_log.dtype == torch.float32,
          "dt and a_log must be float32")
    _need(x.dtype == b.dtype == c.dtype and x.dtype in _DTYPES,
          f"x, b, c must share float32 or bfloat16, got {x.dtype}, "
          f"{b.dtype}, {c.dtype}")
    if not (x.is_cuda or x.is_meta):
        return ref.ssd_scan_ref(x, a_log, b, c, dt)
    _need(all(t.device == x.device for t in (a_log, b, c, dt)),
          "x, a_log, b, c, dt must be on one CUDA device")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    p = plan(x.dtype, P, N,
             strides=[*x.stride(), *b.stride(), *c.stride(), *y.stride()],
             aligned=all(t.data_ptr() % 16 == 0 for t in (x, b, c, y)))
    if y.numel() == 0:
        return y
    if x.is_meta:             # the dry run: reported, not launched
        from repro_torch.launch import hlo_analysis, op_cost
        op_cost.kernel("ssd_scan", p.design, *hlo_analysis.ssd_fwd_cost(
            B, S, H, P, G, N, itemsize=x.element_size()))
        return y
    a_log = a_log.contiguous()
    ptrs = (x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), y.data_ptr())
    dims = (B, S, H, G, P, N)
    strides = (*x.stride(), *b.stride(), *c.stride(), *dt.stride(),
               *y.stride())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    if p.design == "tensor_core":
        err = lib.ssd_scan_tc_launch(*ptrs, *dims, *strides, stream)
    else:
        err = lib.ssd_scan_launch(*ptrs, _DTYPES[x.dtype], *dims, *strides,
                                  stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed ({p.design}): CUDA "
                           f"error {err}")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.launches_by_design[p.design] += 1
    return y


# ---------------------------------------------------------------------------
# The gradient: csrc/ssd_scan_bwd.cu
# ---------------------------------------------------------------------------

BWD_CHUNK = 32         # "cuda_core": steps a staged chunk
BWD_COLS = 32          # "cuda_core": state columns a block
BWD_THREADS = 256


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_bwd_launch.argtypes = (
            [_P] * 12 + [_I] * 7 + [_LL] * 19 + [_P])
        lib.ssd_scan_bwd_tc_launch.argtypes = (
            [_P] * 12 + [_I] * 6 + [_LL] * 19 + [_P])
        for fn in (lib.ssd_scan_bwd_launch, lib.ssd_scan_bwd_tc_launch):
            fn.restype = _I
        lib.ssd_scan_bwd_smem_bytes.argtypes = [_I]
        lib.ssd_scan_bwd_tc_smem_bytes.argtypes = [_I, _I]
        for fn in (lib.ssd_scan_bwd_work_floats,
                   lib.ssd_scan_bwd_tc_work_floats):
            fn.argtypes = [_I] * 5
        for fn in (lib.ssd_scan_bwd_smem_bytes, lib.ssd_scan_bwd_tc_smem_bytes,
                   lib.ssd_scan_bwd_work_floats,
                   lib.ssd_scan_bwd_tc_work_floats):
            fn.restype = _LL
        lib._typed = True
    return lib


class BwdPlan(NamedTuple):
    """How one gradient call runs, as ``csrc/ssd_scan_bwd.cu`` sizes it."""
    design: str        # "tensor_core" or "cuda_core"
    blocks: int        # blocks of the main kernel: (batch, head, chunk)
                       # or (batch, head, slice of 32 state columns)
    smem_bytes: int    # dynamic shared memory of a main-kernel block
    work_floats: int   # float32 workspace the wrapper allocates


def bwd_tc_smem_bytes(P: int, N: int) -> int:
    """Shared bytes of a chunk block of the tensor-core design: bf16 x, dy
    (Q, P + 8), b, c (Q, N + 8), h0 or G as hi and lo (P, N + 8), M1 or M2
    as hi and lo (Q, Q + 8); float32 dt, cum, T's row sums, dc1, xbg (Q,)
    each, the 4 warps' column sums (4, Q) and 8 floats of reductions."""
    q = CHUNK
    return (2 * q * (P + 8) * 2 + 2 * q * (N + 8) * 2 + 2 * P * (N + 8) * 2
            + 2 * q * (q + 8) * 2 + 9 * q * 4 + 8 * 4)


def bwd_plan(dtype: torch.dtype, B: int, S: int, H: int, P: int, N: int, *,
             strides=(), aligned: bool = True) -> BwdPlan:
    """The gradient's design and sizing, by ``plan``'s rule over the
    strides of x, b, c and dy (4 each) and their alignment.  Raises
    ValueError for an input neither design takes (P past 128)."""
    _need(0 < P <= MAX_P, f"head width {P} must be in [1, {MAX_P}]")
    _need(N > 0 and S > 0, f"S={S} and N={N} must be positive")
    if _tensor_core(dtype, P, N, strides, aligned):
        nc = -(-S // CHUNK)
        work = 2 * B * H * nc * P * N + 2 * B * S * H * N + B * H * nc
        p = BwdPlan("tensor_core", B * H * nc, bwd_tc_smem_bytes(P, N),
                    work)
    else:
        pp = next(w for w in (16, 32, 64, 128) if P <= w)
        sub = 8 if pp <= 64 else 4
        ns = -(-N // BWD_COLS)
        q, cols, warps = BWD_CHUNK, BWD_COLS, BWD_THREADS // 32
        smem = 4 * (2 * q * pp + 2 * q * cols + q + 2 * sub * warps * cols
                    + sub * pp + sub * warps)
        nck = -(-S // q)
        work = (B * H * ns * nck * pp * cols + B * S * H * ns * P
                + B * S * H * ns + 2 * B * S * H * N + B * S * H)
        p = BwdPlan("cuda_core", B * H * ns, smem, work)
    _need(p.smem_bytes <= SMEM_LIMIT, f"P={P}, N={N} need {p.smem_bytes} "
          f"bytes of shared memory, past the {SMEM_LIMIT} a block may have")
    return p


def ssd_scan_bwd_cuda(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, dt: torch.Tensor, dy: torch.Tensor):
    """Gradient of ``ssd_scan_cuda`` at (x, a_log, b, c, dt) for the output
    gradient dy (B, S, H, P) in x's dtype: returns (dx, db, dc, ddt,
    da_log), dx, db and dc in x's dtype, ddt (B, S, H) and da_log (H,)
    float32.  The kernels on CUDA tensors (deterministic: no atomics,
    every sum in a fixed order), ``ref.ssd_scan_bwd_ref`` on CPU tensors.
    Any S."""
    _need(x.dim() == 4 and b.dim() == 4 and c.shape == b.shape,
          "x must be (B, S, H, P) and b, c (B, S, G, N)")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    _need(b.shape[:2] == (B, S) and G > 0 and H % G == 0,
          f"b/c {tuple(b.shape)} do not fit x {tuple(x.shape)}")
    _need(dt.shape == (B, S, H) and a_log.shape == (H,),
          f"dt must be {(B, S, H)} and a_log ({H},)")
    _need(dy.shape == x.shape, f"dy {tuple(dy.shape)} must be x's shape")
    _need(dt.dtype == torch.float32 and a_log.dtype == torch.float32,
          "dt and a_log must be float32")
    _need(x.dtype == b.dtype == c.dtype == dy.dtype and x.dtype in _DTYPES,
          f"x, b, c, dy must share float32 or bfloat16, got {x.dtype}, "
          f"{b.dtype}, {c.dtype}, {dy.dtype}")
    if not (x.is_cuda or x.is_meta):
        return ref.ssd_scan_bwd_ref(x, a_log, b, c, dt, dy)
    _need(all(t.device == x.device for t in (a_log, b, c, dt, dy)),
          "x, a_log, b, c, dt, dy must be on one CUDA device")
    dev = x.device
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    db = torch.empty((B, S, G, N), dtype=x.dtype, device=dev)
    dc = torch.empty((B, S, G, N), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    da_log = torch.empty((H,), dtype=torch.float32, device=dev)
    if S == 0 or B == 0:
        return dx, db.zero_(), dc.zero_(), ddt, da_log.zero_()
    strides = [*x.stride(), *b.stride(), *c.stride(), *dy.stride()]
    p = bwd_plan(x.dtype, B, S, H, P, N, strides=strides, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, b, c, dy)))
    work = torch.empty((p.work_floats,), dtype=torch.float32, device=dev)
    if x.is_meta:             # the dry run: reported, not launched
        from repro_torch.launch import hlo_analysis, op_cost
        op_cost.kernel("ssd_scan_bwd", p.design, *hlo_analysis.ssd_bwd_cost(
            B, S, H, P, G, N, itemsize=x.element_size()))
        return dx, db, dc, ddt, da_log
    a_log = a_log.contiguous()
    ptrs = (x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), dy.data_ptr(), dx.data_ptr(), db.data_ptr(),
            dc.data_ptr(), ddt.data_ptr(), da_log.data_ptr(),
            work.data_ptr())
    dims = (B, S, H, G, P, N)
    strides = (*x.stride(), *b.stride(), *c.stride(), *dt.stride(),
               *dy.stride())
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _bwd_lib()
    if p.design == "tensor_core":
        err = lib.ssd_scan_bwd_tc_launch(*ptrs, *dims, *strides, stream)
    else:
        err = lib.ssd_scan_bwd_launch(*ptrs, _DTYPES[x.dtype], *dims,
                                      *strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed ({p.design}): CUDA "
                           f"error {err}")
    ssd_scan_bwd_cuda.launches += 1
    ssd_scan_bwd_cuda.launches_by_design[p.design] += 1
    return dx, db, dc, ddt, da_log


def reset_launches() -> None:
    """Set the launch counts of both wrappers, total and per design, to
    0."""
    for fn in (ssd_scan_cuda, ssd_scan_bwd_cuda):
        fn.launches = 0
        fn.launches_by_design = dict.fromkeys(DESIGNS, 0)


reset_launches()
