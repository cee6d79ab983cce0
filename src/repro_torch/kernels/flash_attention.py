"""Wrappers of the hand-written CUDA flash-attention kernels: the forward
and its gradient.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (built on
first use) on a CUDA tensor or raises; on a CPU tensor it runs the
kernel's plain version, ``ref.attention_ref``.  The source holds two
designs, and ``plan`` picks one from the dtype, the head width and the
alignment before the launch: "tensor_core" (bf16 on ``mma.sync``, 64
query rows a block) or "cuda_core" (one warp a query row, float32
products).  With ``return_lse`` it also returns each row's log-sum-exp,
which the gradient needs.

``flash_attention_bwd_cuda`` launches ``csrc/flash_attention_bwd.cu``,
the gradient of the reference's custom VJP (``models/flash_xla.py``
``_bwd_vjp``), or on CPU tensors its plain version,
``ref.flash_attention_bwd_ref``; ``bwd_plan`` picks its design by the
same rule ("tensor_core" there is bf16 on ``wgmma``, fed by TMA through
a ring of stages, and also needs every stride positive).  Each wrapper
counts its launches in ``launches`` and, per design, in
``launches_by_design``.

On meta tensors (the dry run's device, ``launch/dryrun.py``) both take
the card's route up to the launch -- the checks, ``plan`` or
``bwd_plan`` at the call's shapes and strides, the outputs and
workspace -- then report the launch to ``launch/op_cost.py`` with its
cost instead of making it: no launch is counted.
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
# the gradient's tensor-core design (csrc/flash_attention_bwd.cu)
BWD_TC_KEYS = 64       # keys a dK/dV block owns
BWD_TC_QUERIES = 64    # queries of one of its stages
BWD_TC_ROWS = 128      # query rows a dQ block owns, 64 a warpgroup
BWD_KV_STAGES = 2      # staged Q, dO tile pairs of a dK/dV block
BWD_DQ_STAGES = 3      # staged K, V tile pairs of a dQ block
DESIGNS = ("tensor_core", "cuda_core")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = (
            [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I] + [_LL] * 12 + [_P])
        lib.flash_attention_launch.restype = _I
        lib.flash_attention_tc_launch.argtypes = (
            [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I] + [_LL] * 12 + [_P])
        lib.flash_attention_tc_launch.restype = _I
        lib.flash_attention_smem_bytes.argtypes = [_I, _I]
        lib.flash_attention_smem_bytes.restype = _LL
        lib._typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_bwd_launch.argtypes = (
            [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I] + [_LL] * 15 + [_P])
        lib.flash_attention_bwd_launch.restype = _I
        lib.flash_attention_bwd_tc_launch.argtypes = (
            [_P] * 10 + [_I] * 6 + [ctypes.c_float, _I] + [_LL] * 15 + [_P])
        lib.flash_attention_bwd_tc_launch.restype = _I
        lib.flash_attention_bwd_smem_bytes.argtypes = [_I, _I, _I]
        lib.flash_attention_bwd_smem_bytes.restype = _LL
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


def _tensor_core(dtype, dh, strides, aligned) -> bool:
    """Whether a call takes the tensor-core design (forward and gradient
    alike): bf16, dh % 16 == 0, every stride a whole number of 16-byte
    chunks and every pointer 16-byte aligned.  Raises ValueError for a
    head width neither design takes."""
    _need(dh % 4 == 0 and 0 < dh <= MAX_DH,
          f"head width {dh} must be a multiple of 4 in [4, {MAX_DH}]")
    return (dtype == torch.bfloat16 and dh % 16 == 0 and aligned
            and all(s % 8 == 0 for s in strides))


def plan(dtype: torch.dtype, dh: int, Sq: int, *, strides=(),
         aligned: bool = True) -> Plan:
    """The design and sizing of a call at head width dh and Sq query rows.

    ``strides`` are the (batch, head, row) element strides of q, k, v and
    o, ``aligned`` whether their data pointers are 16-byte aligned.  bf16
    with dh % 16 == 0 and every stride a whole number of 16-byte chunks
    takes the tensor-core design; float32 (whose tolerance bf16 products
    could not meet) and any other bf16 input the CUDA-core one.  Raises
    ValueError for an input neither design takes."""
    if _tensor_core(dtype, dh, strides, aligned):
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


def _check(q, k, v, causal):
    """The shapes and dtypes both wrappers take; returns (B, H, Hkv, Sq,
    Sk, dh, dv).  v may be narrower than q and k (dv <= dh: MLA's
    values), as the reference's ``flash_attention_xla`` takes it."""
    _need(q.dim() == 4 and k.dim() == 4 and v.dim() == 4
          and v.shape[:3] == k.shape[:3] and 0 < v.shape[3] <= k.shape[3],
          "q must be (B, H, Sq, dh), k (B, Hkv, Sk, dh) and v (B, Hkv, "
          "Sk, dv) with dv <= dh")
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
    return B, H, Hkv, Sq, Sk, dh, v.shape[3]


def _widen(t: torch.Tensor, dh: int) -> torch.Tensor:
    """t (..., dv) zero-padded to (..., dh): a narrow v (and, in the
    gradient, o and dout) as the kernels' one head width.  The padded
    columns of O are P @ 0 = 0, so lse, delta, dQ and dK are those of
    the narrow call, and its O and dV are the first dv columns."""
    return t if t.shape[-1] == dh else torch.nn.functional.pad(
        t, (0, dh - t.shape[-1]))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, scale: float | None = None,
                         return_lse: bool = False):
    """Attention of q (B, H, Sq, dh) against k (B, Hkv, Sk, dh) and v
    (B, Hkv, Sk, dv), dv <= dh, H a multiple of Hkv (query head h reads
    kv head h // (H // Hkv)); f32 or bf16, all alike; returns (B, H, Sq,
    dv) in q's dtype and, with ``return_lse``, each row's log-sum-exp of
    its scaled scores (B, H, Sq) float32 (the output's bits are the same
    either way).

    Any Sq and Sk (nothing is padded).  ``causal`` masks keys past the
    query's own position, aligned top-left as the TPU kernel aligns it;
    the reference's plain version aligns bottom-right, and the two agree
    only at Sq == Sk, so causal attention with Sq != Sk is refused.  The
    kernel computes at one head width: a narrower v is zero-padded to dh
    for the launch (``_widen``) and the output is the view of its first
    dv columns.
    """
    B, H, Hkv, Sq, Sk, dh, dv = _check(q, k, v, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if not (q.is_cuda or q.is_meta):
        return ref.attention_ref(q, k, v, causal=causal, scale=scale,
                                 return_lse=return_lse)
    _need(k.device == q.device and v.device == q.device,
          "q, k, v must be on one CUDA device")
    v = _widen(v, dh)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        _need(t.stride(3) == 1, f"{name}: the head dim must be unit-stride")
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    p = plan(q.dtype, dh, Sq, strides=strides,
             aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v, o)))
    if o.numel() == 0:
        o = o[..., :dv]
        return (o, lse) if return_lse else o
    if q.is_meta:             # the dry run: reported, not launched
        from repro_torch.launch import hlo_analysis, op_cost
        op_cost.kernel("flash_attention", p.design, *hlo_analysis
                       .flash_fwd_cost(B, H, Hkv, Sq, Sk, dh, dv,
                                       causal=causal,
                                       itemsize=q.element_size(),
                                       lse=return_lse))
        o = o[..., :dv]
        return (o, lse) if return_lse else o
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if return_lse else None)
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
    o = o[..., :dv]
    return (o, lse) if return_lse else o


class BwdPlan(NamedTuple):
    """How one gradient call runs, as ``csrc/flash_attention_bwd.cu``
    sizes it: a dK/dV block owns ``key_rows`` keys and stages
    ``query_tile`` queries at a time; a dQ block owns ``dq_rows`` query
    rows and stages ``dq_key_tile`` keys at a time; ``dkdv_stages`` and
    ``dq_stages`` tiles are in flight (the tensor-core design's rings; 1:
    staged, then used); the caller's float32 workspace holds
    ``workspace_rows`` values of each (batch, head)."""
    design: str        # "tensor_core" or "cuda_core"
    key_rows: int
    query_tile: int
    dq_rows: int
    dq_key_tile: int
    dkdv_stages: int
    dq_stages: int
    dkdv_smem_bytes: int
    dq_smem_bytes: int
    workspace_rows: int


def padded_width(dh: int) -> int:
    """The head width the gradient's tensor-core design computes at:
    whole 64-column panels of its 128-byte-swizzled tiles (64, 128 or
    256; the columns past dh are zeros)."""
    return 64 if dh <= 64 else 128 if dh <= 128 else 256


def bwd_plan(dtype: torch.dtype, dh: int, Sq: int, Sk: int, *, strides=(),
             aligned: bool = True) -> BwdPlan:
    """The gradient's design and sizing, by ``plan``'s rule over the
    (batch, head, row) strides of q, k, v, o and dout, each also positive
    for the tensor-core design (its TMA tensor maps step every dimension).
    Its shared memory: 1,024 bytes of slack to align the swizzled tiles,
    the tiles (dK/dV: K, V and two pairs of Q, dO tiles of 64 rows; dQ:
    Q, dO of 128 rows and three pairs of K, V tiles), P^T's 8 KB
    hand-over between the dK/dV block's two warpgroups and each dK/dV
    stage's 64 lse and delta values, and 64 bytes of mbarriers.  Its
    workspace: the lse in log2 units and delta, each padded with zeros to
    whole tiles of 64 rows (delta alone, Sq rows, for the CUDA-core
    design).  Raises ValueError for an input neither design takes."""
    if (_tensor_core(dtype, dh, strides, aligned)
            and all(s > 0 for s in strides)):
        dmp, kt = padded_width(dh), key_tile(dh)
        tile = BWD_TC_KEYS * dmp * 2
        p = BwdPlan("tensor_core", BWD_TC_KEYS, BWD_TC_QUERIES, BWD_TC_ROWS,
                    kt, BWD_KV_STAGES, BWD_DQ_STAGES,
                    1024 + (2 + 2 * BWD_KV_STAGES) * tile
                    + BWD_TC_KEYS * BWD_TC_QUERIES * 2
                    + BWD_KV_STAGES * 2 * BWD_TC_QUERIES * 4 + 64,
                    1024 + (2 * BWD_TC_ROWS + 2 * BWD_DQ_STAGES * kt) * dmp
                    * 2 + 64,
                    2 * -(-Sq // BWD_TC_QUERIES) * BWD_TC_QUERIES)
    else:
        p = BwdPlan("cuda_core", 8, 32, CC_ROWS, CC_TILE_K, 1, 1,
                    (2 * 8 * dh + 2 * 32 * (dh + 4) + 2 * 32) * 4,
                    (2 * CC_ROWS * dh + 2 * CC_TILE_K * (dh + 4)) * 4, Sq)
    _need(-(-Sk // p.key_rows) <= MAX_ROW_TILES, f"Sk={Sk} too long")
    _need(-(-Sq // p.dq_rows) <= MAX_ROW_TILES, f"Sq={Sq} too long")
    for smem in (p.dkdv_smem_bytes, p.dq_smem_bytes):
        _need(smem <= SMEM_LIMIT, f"dh={dh} needs {smem} bytes of shared "
              f"memory, past the {SMEM_LIMIT} a block may have")
    return p


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradient of ``flash_attention_cuda``: (dq, dk, dv) of q, k, v
    given its output o, its ``lse`` (B, H, Sq) float32 and the output's
    gradient ``dout``, all in q's dtype (o and dout shaped (B, H, Sq,
    dv), as the forward's output).  The outputs are new contiguous
    tensors in the inputs' dtype.

    q, k, v, o and dout are read through their strides; an input whose
    head dim is not unit-stride (which autograd may hand over as
    ``dout``) is copied once first.  A v narrower than q and k is
    zero-padded to dh with o and dout (``_widen``: the padded columns
    add nothing to delta or dP) and dV is the first dv columns of the
    kernel's.  No atomics: two launches are bitwise alike.
    """
    B, H, Hkv, Sq, Sk, dh, dv_dim = _check(q, k, v, causal)
    _need(o.shape == dout.shape == (B, H, Sq, dv_dim),
          f"o and dout must be shaped ({B}, {H}, {Sq}, {dv_dim})")
    _need(o.dtype == dout.dtype == q.dtype,
          f"o and dout must be {q.dtype}, got {o.dtype}, {dout.dtype}")
    _need(lse.shape == (B, H, Sq) and lse.dtype == torch.float32,
          f"lse must be ({B}, {H}, {Sq}) float32")
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if not (q.is_cuda or q.is_meta):
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                           causal=causal, scale=scale)
    _need(all(t.device == q.device for t in (k, v, o, lse, dout)),
          "every input must be on one CUDA device")
    v, o, dout = (_widen(t, dh) for t in (v, o, dout))
    q, k, v, o, dout = (t if t.stride(3) == 1 else t.contiguous()
                        for t in (q, k, v, o, dout))
    lse = lse.contiguous()
    dq = torch.empty((B, H, Sq, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Sk, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    strides = [s for t in (q, k, v, o, dout) for s in t.stride()[:3]]
    p = bwd_plan(q.dtype, dh, Sq, Sk, strides=strides, aligned=all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, o, dout, dq, dk, dv)))
    if B * H * Sq == 0:        # no query: nothing reaches k or v
        return dq, dk.zero_(), dv[..., :dv_dim].zero_().contiguous()
    delta = torch.empty((B, H, p.workspace_rows), dtype=torch.float32,
                        device=q.device)
    if q.is_meta:             # the dry run: reported, not launched
        from repro_torch.launch import hlo_analysis, op_cost
        op_cost.kernel("flash_attention_bwd", p.design, *hlo_analysis
                       .flash_bwd_cost(B, H, Hkv, Sq, Sk, dh, dv_dim,
                                       causal=causal,
                                       itemsize=q.element_size()))
        return dq, dk, dv if dv_dim == dh else dv[..., :dv_dim].contiguous()
    ptrs = tuple(t.data_ptr() for t in (q, k, v, o, dout, lse, delta, dq,
                                        dk, dv))
    shape = (B, H, Hkv, Sq, Sk, dh, float(scale), int(causal))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _bwd_lib()
    if p.design == "tensor_core":
        err = lib.flash_attention_bwd_tc_launch(*ptrs, *shape, *strides,
                                                stream)
    else:
        err = lib.flash_attention_bwd_launch(*ptrs, _DTYPES[q.dtype], *shape,
                                             *strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed ({p.design}):"
                           f" CUDA error {err}")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.launches_by_design[p.design] += 1
    return dq, dk, dv if dv_dim == dh else dv[..., :dv_dim].contiguous()


def reset_launches() -> None:
    """Set the launch counts of both wrappers, total and per design, to
    0."""
    for fn in (flash_attention_cuda, flash_attention_bwd_cuda):
        fn.launches = 0
        fn.launches_by_design = dict.fromkeys(DESIGNS, 0)


reset_launches()
