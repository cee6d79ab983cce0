"""Wrapper of the hand-written CUDA p-stable hash kernel.

``lsh_hash_cuda`` launches ``csrc/lsh_hash.cu`` (built on first use) on
CUDA tensors or raises; on CPU tensors it runs the kernel's plain
version, ``ref.lsh_hash_ref``.  It counts its kernel launches in
``launches``.  The index does not call it: it hashes with
``core.hashing.hash_h``, whose fixed summation tree keeps insert,
dispatch and receive side bitwise equal on every device; this kernel
sums each dot in one ascending chain of fused multiply-adds.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("lsh_hash")
    if not getattr(lib, "_typed", False):
        lib.lsh_hash_launch.argtypes = ([_P] * 4 + [_I, _LL, _I, _I,
                                                    ctypes.c_float]
                                        + [_LL] * 2 + [_P])
        lib.lsh_hash_launch.restype = _I
        lib._typed = True
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def lsh_hash_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                  w: float) -> torch.Tensor:
    """floor((x @ a + b) / w) as int32 (n, K): x (n, d) float32 or
    bfloat16, a (d, K) and b (K,) float32, w > 0.  Any n and K."""
    _need(x.dim() == 2 and a.dim() == 2 and b.dim() == 1,
          "x must be (n, d), a (d, K) and b (K,)")
    n, d = x.shape
    K = a.shape[1]
    _need(a.shape[0] == d and b.shape[0] == K,
          f"a {tuple(a.shape)} and b {tuple(b.shape)} do not match x "
          f"{tuple(x.shape)}")
    _need(x.dtype in _DTYPES, f"x must be float32 or bfloat16, got {x.dtype}")
    _need(a.dtype == b.dtype == torch.float32, "a and b must be float32")
    _need(w > 0, f"w must be positive, got {w}")
    if not x.is_cuda:
        return ref.lsh_hash_ref(x, a, b, w=w)
    _need(a.device == x.device and b.device == x.device,
          "x, a, b must be on one CUDA device")
    _need(d > 0 and K > 0, "d and K must be positive")
    out = torch.empty((n, K), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    a, b = a.contiguous(), b.contiguous()
    err = _lib().lsh_hash_launch(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        _DTYPES[x.dtype], n, d, K, float(w), *x.stride(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lsh_hash launch failed: CUDA error {err}")
    lsh_hash_cuda.launches += 1
    return out


lsh_hash_cuda.launches = 0
