"""Full-sequence GQA/MQA attention.

``sdpa`` is the port's one score path: the hand-written flash kernel on
the card (``kernels/ops.flash_attention``), its plain version on the CPU,
differentiable through the gradient kernel (``models/flash_xla.py``).
The reference chooses among an einsum, a chunked scan, its custom-VJP
flash and its TPU kernel by shape and by a ``use_kernel`` switch; all
compute the same function, and the port has no switch.  The reference's
einsum and chunked paths exist to carry ``q_offset`` and ``window``,
which no ported block uses: they come with the decode path and its KV
cache (ROADMAP Queue 1 item 11.3) and with the sliding window and MLA
(item 11.4).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.flash_xla import flash_attention_xla
from repro_torch.models.layers import apply_rope, he_init_, param


def sdpa(q, k, v, *, causal: bool = True):
    """Scaled dot-product attention, q (B, H, Sq, hd) against k, v
    (B, Hkv, Sk, hd); differentiable in q, k and v."""
    return flash_attention_xla(q, k, v, causal)


class Attention(nn.Module):
    """q/k/v projections, RoPE, attention and the output projection."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = cfg.pdtype
        self.wq = param(d, H * hd, dtype=dt, device=device)
        self.wk = param(d, Hkv * hd, dtype=dt, device=device)
        self.wv = param(d, Hkv * hd, dtype=dt, device=device)
        self.wo = param(H * hd, d, dtype=dt, device=device)

    def reset_parameters(self, generator) -> None:
        """The reference's ``init_attention``: normal / sqrt(fan_in)."""
        for w in (self.wq, self.wk, self.wv, self.wo):
            he_init_(w, generator)

    def forward(self, x):
        return attention(self, self.cfg, x)


def attention(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (B, S, d), causal over the full sequence at
    positions 0..S-1.
    The kernel reads q, k and v through their strides, so v stays a view
    of its projection."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p.wq).view(B, S, H, hd).transpose(1, 2)
    k = (x @ p.wk).view(B, S, Hkv, hd).transpose(1, 2)
    v = (x @ p.wv).view(B, S, Hkv, hd).transpose(1, 2)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = sdpa(q, k, v, causal=True)
    return out.transpose(1, 2).reshape(B, S, H * hd) @ p.wo
