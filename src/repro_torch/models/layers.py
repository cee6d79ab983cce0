"""Shared model layers: init, RMSNorm, RoPE, the gated MLP, embeddings,
the cross entropy of training, the causal depthwise conv of the Mamba-2
block.

Plain functions on tensors, and ``nn.Module``s that hold the parameters
and call them.  Weights keep the reference's layout, (d_in, d_out) used
as ``x @ W``, so parameters carry across unchanged (``convert.py``), and
the large products stay ``torch.matmul`` (in float32 with TF32 off:
PyTorch's default, which ``core.hashing`` also sets when imported).

The layers follow the reference, not the published Gemma: the norm
multiplies by ``scale`` (not ``1 + scale``), and the embedding is not
scaled by sqrt(d_model).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def he_init_(w: torch.Tensor, generator: torch.Generator,
             fan_in: int | None = None) -> torch.Tensor:
    """Fill w in place with normal / sqrt(fan_in) (fan_in defaults to
    w's first dimension), drawn in float32 and rounded to w's dtype."""
    fan_in = fan_in or w.shape[0]
    draw = torch.randn(w.shape, generator=generator, device=generator.device)
    return w.copy_(draw / math.sqrt(fan_in))


def param(*shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter, frozen: the serving paths take no
    gradients, and the trainer turns them on (``requires_grad_``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.scale = param(d, dtype=dtype, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.scale.fill_(1.0)

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    expo = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), expo)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x: (..., S, hd); pos: (S,) integer positions."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (hd/2,)
    ang = pos.float()[..., :, None] * freqs                 # (S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp(p, x, act: str):
    """p has w_gate, w_up (d, f) and w_down (f, d); GeGLU's gelu is the
    tanh approximation."""
    g = x @ p.w_gate
    u = x @ p.w_up
    h = (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * u
    return h @ p.w_down


class MLP(nn.Module):
    def __init__(self, d: int, f: int, act: str, dtype, device=None):
        super().__init__()
        self.act = act
        self.w_gate = param(d, f, dtype=dtype, device=device)
        self.w_up = param(d, f, dtype=dtype, device=device)
        self.w_down = param(f, d, dtype=dtype, device=device)

    def reset_parameters(self, generator) -> None:
        he_init_(self.w_gate, generator)
        he_init_(self.w_up, generator)
        he_init_(self.w_down, generator)

    def forward(self, x):
        return mlp(self, x, self.act)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(head: torch.Tensor, x: torch.Tensor, softcap: float = 0.0):
    logits = (x @ head).float()
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over all positions, in the reference's
    arithmetic (float32): the row max shifted out without a gradient, and
    the label logit taken by a masked sum over the vocab axis rather than
    a gather.  Padded vocab columns come in masked at -1e30 (``_logits``)
    and so add nothing."""
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    shifted = lf - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    vocab_ids = torch.arange(lf.shape[-1], device=lf.device)
    label_logit = torch.sum(
        torch.where(vocab_ids == labels[..., None], shifted, 0.0), dim=-1)
    return torch.mean(lse - label_logit)


# ---------------------------------------------------------------------------
# Causal depthwise short conv (the Mamba-2 frontend)
# ---------------------------------------------------------------------------

def causal_conv1d(p, x: torch.Tensor, state: torch.Tensor | None = None):
    """x: (B, S, C) depthwise causal conv of width W with p.w (W, C) and
    p.b (C,): y_t = sum_i w_i x_{t-W+1+i} + b, a shifted sum over the W
    taps in float32 (not ``F.conv1d``: cuDNN would run float32 in TF32),
    cast back to x's dtype.

    state: (B, W-1, C) trailing context of earlier steps, or None for
    zero left-padding (the full-sequence form the port runs).  Returns
    (y, new_state).
    """
    w = p.w.float()                                     # (W, C)
    W = w.shape[0]
    B, S, C = x.shape
    if state is None:
        state = torch.zeros((B, W - 1, C), dtype=torch.float32,
                            device=x.device)
    xp = torch.cat([state.float(), x.float()], dim=1)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + w[i] * xp[:, i:i + S]
    y = y + p.b.float()
    new_state = xp[:, S:] if W > 1 else state
    return y.to(x.dtype), new_state.to(x.dtype)


class CausalConv1d(nn.Module):
    """Parameters of ``causal_conv1d``: w (W, C) and b (C,)."""

    def __init__(self, channels: int, width: int, dtype, device=None):
        super().__init__()
        self.w = param(width, channels, dtype=dtype, device=device)
        self.b = param(channels, dtype=dtype, device=device)

    def reset_parameters(self, generator) -> None:
        """The reference's ``init_conv1d``: w normal / sqrt(width), b 0."""
        he_init_(self.w, generator, fan_in=self.w.shape[0])
        self.b.zero_()
