"""Wrapper of the hand-written CUDA flash-attention kernels.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (built on
first use) on a CUDA tensor or raises; on a CPU tensor it runs the
kernel's plain version, ``ref.attention_ref``.  The source holds two
designs, and ``plan`` picks one from the dtype, the head width and the
alignment before the launch: "tensor_core" (bf16 on ``mma.sync``, 64
query rows a block) or "cuda_core" (one warp a query row, float32
products).  The wrapper counts its launches in ``launches`` and, per
design, in ``launches_by_design``.  There is no gradient: the port
serves, and the TPU kernel it replaces has no backward either.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

MAX_DH = 256           # widest head either design takes
MAX_ROW_TILES = 65535  # grid rows: one block of query rows each
SMEM_LIMIT = 232_448   # shared memory a block may have on Hopper
TC_ROWS = 64           # query rows a tensor-core block owns, 16 a warp
CC_ROWS = 16           # query rows a CUDA-core block owns, 1 a warp
CC_TILE_K = 32         # keys a CUDA-core block stages at a time
DESIGNS = ("tensor_core", "cuda_core")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = (
            [_P] * 4 + [_I] * 7 + [ctypes.c_float, _I] + [_LL] * 12 + [_P])
        lib.flash_attention_launch.restype = _I
        lib.flash_attention_tc_launch.argtypes = (
            [_P] * 4 + [_I] * 6 + [ctypes.c_float, _I] + [_LL] * 12 + [_P])
        lib.flash_attention_tc_launch.restype = _I
        lib.flash_attention_smem_bytes.argtypes = [_I, _I]
        lib.flash_attention_smem_bytes.restype = _LL
        lib._typed = True
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


class Plan(NamedTuple):
    """How one call runs, as ``csrc/flash_attention.cu`` sizes it."""
    design: str        # "tensor_core" or "cuda_core"
    block_rows: int    # query rows a block owns
    key_tile: int      # keys a block stages at a time
    smem_bytes: int    # dynamic shared memory a block needs


def key_tile(dh: int) -> int:
    """Keys of one staged K/V tile of the tensor-core design: 64 up to
    dh = 128, 32 above, so two blocks fit an SM."""
    return 64 if dh <= 128 else 32


def plan(dtype: torch.dtype, dh: int, Sq: int, *, strides=(),
         aligned: bool = True) -> Plan:
    """The design and sizing of a call at head width dh and Sq query rows.

    ``strides`` are the (batch, head, row) element strides of q, k, v and
    o, ``aligned`` whether their data pointers are 16-byte aligned.  bf16
    with dh % 16 == 0 and every stride a whole number of 16-byte chunks
    takes the tensor-core design; float32 (whose tolerance bf16 products
    could not meet) and any other bf16 input the CUDA-core one.  Raises
    ValueError for an input neither design takes."""
    _need(dh % 4 == 0 and 0 < dh <= MAX_DH,
          f"head width {dh} must be a multiple of 4 in [4, {MAX_DH}]")
    if (dtype == torch.bfloat16 and dh % 16 == 0 and aligned
            and all(s % 8 == 0 for s in strides)):
        kt = key_tile(dh)
        p = Plan("tensor_core", TC_ROWS, kt,
                 (TC_ROWS + 4 * kt) * (dh + 8) * 2)
    else:
        p = Plan("cuda_core", CC_ROWS, CC_TILE_K,
                 (CC_ROWS * dh + CC_TILE_K * (dh + 4) + CC_TILE_K * dh) * 4)
    _need(-(-Sq // p.block_rows) <= MAX_ROW_TILES, f"Sq={Sq} too long")
    _need(p.smem_bytes <= SMEM_LIMIT, f"dh={dh} needs {p.smem_bytes} bytes "
          f"of shared memory, past the {SMEM_LIMIT} a block may have")
    return p


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, scale: float | None = None
                         ) -> torch.Tensor:
    """Attention of q (B, H, Sq, dh) against k, v (B, Hkv, Sk, dh), H a
    multiple of Hkv (query head h reads kv head h // (H // Hkv)); f32 or
    bf16, all alike; returns (B, H, Sq, dh) in q's dtype.

    Any Sq and Sk (nothing is padded).  ``causal`` masks keys past the
    query's own position, aligned top-left as the TPU kernel aligns it;
    the reference's plain version aligns bottom-right, and the two agree
    only at Sq == Sk, so causal attention with Sq != Sk is refused.
    """
    _need(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
          "q must be (B, H, Sq, dh) and k, v (B, Hkv, Sk, dh)")
    B, H, Sq, dh = q.shape
    _, Hkv, Sk, _ = k.shape
    _need(k.shape[0] == B and k.shape[3] == dh,
          f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    _need(Hkv > 0 and H % Hkv == 0, f"H={H} is not a multiple of Hkv={Hkv}")
    _need(q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES,
          f"q, k, v must share float32 or bfloat16, got "
          f"{q.dtype}, {k.dtype}, {v.dtype}")
    _need(not causal or Sq == Sk,
          f"causal attention needs Sq == Sk (got {Sq}, {Sk}): the TPU "
          f"kernel and the reference's plain version align the mask "
          f"differently otherwise")
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if not q.is_cuda:
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    _need(k.device == q.device and v.device == q.device,
          "q, k, v must be on one CUDA device")
    o = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        _need(t.stride(3) == 1, f"{name}: the head dim must be unit-stride")
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    p = plan(q.dtype, dh, Sq, strides=strides,
             aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v, o)))
    if o.numel() == 0:
        return o
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    shape = (B, H, Hkv, Sq, Sk, dh, float(scale), int(causal))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _lib()
    if p.design == "tensor_core":
        err = lib.flash_attention_tc_launch(*ptrs, *shape, *strides, stream)
    else:
        err = lib.flash_attention_launch(*ptrs, _DTYPES[q.dtype], *shape,
                                         *strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed ({p.design}): "
                           f"CUDA error {err}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_design[p.design] += 1
    return o


def reset_launches() -> None:
    """Set the launch counts, total and per design, to 0."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.launches_by_design = dict.fromkeys(DESIGNS, 0)


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_design = dict.fromkeys(DESIGNS, 0)
