"""``flash_attention_xla``: the reference's name for its differentiable
attention (``src/repro/models/flash_xla.py``, a ``jax.custom_vjp`` that
saves only (out, lse) and recomputes the scores blockwise in the
backward, the FlashAttention-2 recipe).

In the port the same function is ``kernels/ops.flash_attention``: under
autograd an ``autograd.Function`` whose forward is the flash kernel with
its log-sum-exp and whose backward is the hand-written gradient kernel
(``csrc/flash_attention_bwd.cu``); on CPU tensors their plain versions.
This module is a thin call of it, so that a reader finds the counterpart
of the custom VJP under the reference's name.
"""
from __future__ import annotations

from repro_torch.kernels import ops


def flash_attention_xla(q, k, v, causal: bool = True, scale=None):
    """q (B, H, Sq, dh) against k (B, Hkv, Sk, dh) and v (B, Hkv, Sk,
    dv) -> (B, H, Sq, dv), differentiable in q, k and v.  v's width may
    be below q's (MLA: q/k 192, v 128), as the reference's takes it; the
    default scale is 1 / sqrt(dh), q's width."""
    return ops.flash_attention(q, k, v, causal=causal, scale=scale)
