"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
  a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)),   c = 8

The block is the reference's (``src/repro/models/rglru.py``): the causal
conv frontend, the RG-LRU and the gated output.  The recurrence is a
log-depth scan over the sequence axis in plain PyTorch (``linear_scan``:
Hillis-Steele doubling, ceil(log2 S) steps, differentiable by autograd),
as the reference's is ``jax.lax.associative_scan`` with no Pallas
kernel; a stateful call (prefill and decode through a cache) folds the
carried h into the first step and returns the new conv state and h.

The gates are IEEE float32 products (TF32 off, as PyTorch's default and
``core.hashing`` keep it), and ``lam`` is float32 in a bf16 model, as the
reference keeps it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.index import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (CausalConv1d, causal_conv1d,
                                       he_init_, param)

_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, log(1 + e^x) everywhere (``F.softplus`` switches
    to the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class RGLRU(nn.Module):
    """The reference's ``init_rglru`` leaves: w_x, w_gate_out (d, w),
    conv (``CausalConv1d`` of w channels), w_input_gate, w_rec_gate (w,
    w), lam (w,) float32 whatever the parameter dtype, w_out (w, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, w, dt = cfg.d_model, _width(cfg), cfg.pdtype
        self.w_x = param(d, w, dtype=dt, device=device)
        self.w_gate_out = param(d, w, dtype=dt, device=device)
        self.conv = CausalConv1d(w, cfg.rglru.d_conv, dt, device)
        self.w_input_gate = param(w, w, dtype=dt, device=device)
        self.w_rec_gate = param(w, w, dtype=dt, device=device)
        self.lam = param(w, dtype=torch.float32, device=device)
        self.w_out = param(w, d, dtype=dt, device=device)

    def reset_parameters(self, generator) -> None:
        """The reference's ``init_rglru``: projections normal /
        sqrt(fan_in), Lambda such that a^c spans (0.9, 0.999) as in the
        paper (the conv resets itself)."""
        w = self.lam.shape[0]
        for t in (self.w_x, self.w_gate_out, self.w_input_gate,
                  self.w_rec_gate, self.w_out):
            he_init_(t, generator)
        lin = torch.linspace(0.9, 0.999, w, dtype=torch.float32)
        self.lam.copy_(torch.log(torch.expm1(-torch.log(lin) / _C)))

    def forward(self, x, *, state=None):
        return rglru_block(self, self.cfg, x, state=state)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_{-1} = 0, for a, b (B,
    S, w): the associative scan of (a, b) pairs under comb(l, r) = (a_l
    a_r, b_r + a_r b_l), by Hillis-Steele doubling -- after the step of
    stride s each position holds the pair of the 2s positions ending at
    it -- in ceil(log2 S) out-of-place steps, so autograd differentiates
    it.  Returns h (B, S, w)."""
    S, s = a.shape[1], 1
    while s < S:
        b = torch.cat([b[:, :s], b[:, s:] + a[:, s:] * b[:, :-s]], dim=1)
        if 2 * s < S:            # the last step needs no products of a
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def rglru_block(p, cfg: ModelConfig, xin: torch.Tensor, *, state=None):
    """xin: (B, S, d) -> (B, S, d), the full sequence from a zero state.
    With ``state`` ({"conv": (B, W-1, w), "h": (B, w) float32}) the
    sequence continues from it, and the result is (out, new_state)."""
    B, S, _ = xin.shape
    x = xin @ p.w_x                                          # (B, S, w)
    gate_out = F.gelu((xin @ p.w_gate_out).float(), approximate="tanh")
    x, new_conv = causal_conv1d(p.conv, x,
                                None if state is None else state["conv"])
    xf = x.float()
    i_t = torch.sigmoid(xf @ p.w_input_gate.float())
    r_t = torch.sigmoid(xf @ p.w_rec_gate.float())
    a = torch.exp(-_C * softplus(p.lam) * r_t)               # (B, S, w)
    b = i_t * xf * torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    if state is not None:        # fold h0 into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * state["h"].float()[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    out = (h * gate_out).to(xin.dtype) @ p.w_out
    if state is None:
        return out
    return out, {"conv": new_conv, "h": h[:, -1]}


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """A zero state on ``device`` (``cuda`` unless given; raises without a
    card): conv (B, d_conv - 1, w) in the compute dtype, h (B, w) in
    float32."""
    device = resolve_device(device)
    w = _width(cfg)
    return {"conv": torch.zeros((batch, cfg.rglru.d_conv - 1, w),
                                dtype=cfg.cdtype, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32,
                             device=device)}
