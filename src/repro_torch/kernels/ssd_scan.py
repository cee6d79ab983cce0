"""Wrapper of the hand-written CUDA SSD chunked-scan kernel (Mamba-2).

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu`` (built on first use) on
CUDA tensors or raises; on CPU tensors it runs the kernel's plain
version, ``ref.ssd_scan_ref`` (the sequential scan).  It counts its
kernel launches in ``launches``.  Nothing is padded or repeated: the
kernel masks a ragged last chunk itself and reads B and C at each head's
group through their strides.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_P = 128            # widest head the kernel takes (8 columns a thread)
SMEM_LIMIT = 232_448   # shared memory a block may have on Hopper

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_launch.argtypes = [_P] * 6 + [_I] * 7 + [_LL] * 19 + [_P]
        lib.ssd_scan_launch.restype = _I
        lib.ssd_scan_smem_bytes.argtypes = [_I, _I]
        lib.ssd_scan_smem_bytes.restype = _LL
        lib._typed = True
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


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
    if not x.is_cuda:
        return ref.ssd_scan_ref(x, a_log, b, c, dt)
    _need(all(t.device == x.device for t in (a_log, b, c, dt)),
          "x, a_log, b, c, dt must be on one CUDA device")
    _need(0 < P <= MAX_P, f"head width {P} must be in [1, {MAX_P}]")
    lib = _lib()
    smem = lib.ssd_scan_smem_bytes(P, N)
    _need(smem <= SMEM_LIMIT, f"P={P}, N={N} need {smem} bytes of shared "
          f"memory, past the {SMEM_LIMIT} a block may have")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    a_log = a_log.contiguous()
    err = lib.ssd_scan_launch(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
        a_log.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], B, S, H, G, P, N,
        *x.stride(), *b.stride(), *c.stride(), *dt.stride(), *y.stride(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan_cuda.launches += 1
    return y


ssd_scan_cuda.launches = 0
