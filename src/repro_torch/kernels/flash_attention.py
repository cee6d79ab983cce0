"""Wrapper of the hand-written CUDA flash-attention kernel.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (built on
first use) on a CUDA tensor or raises; on a CPU tensor it runs the
kernel's plain version, ``ref.attention_ref``.  It counts its kernel
launches in ``launches``.  There is no gradient: the port serves, and the
TPU kernel it replaces has no backward either.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

MAX_DH = 256           # widest head the kernel takes (a lane holds 8 columns)
MAX_ROW_TILES = 65535  # grid rows: 16 query rows each

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
        lib._typed = True
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


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
    _need(dh % 4 == 0 and 0 < dh <= MAX_DH,
          f"head width {dh} must be a multiple of 4 in [4, {MAX_DH}]")
    _need(-(-Sq // 16) <= MAX_ROW_TILES, f"Sq={Sq} too long")
    o = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        _need(t.stride(3) == 1, f"{name}: the head dim must be unit-stride")
    if o.numel() == 0:
        return o
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], B, H, Hkv, Sq, Sk, dh, float(scale), int(causal),
        *strides, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
