"""Mamba-2 block (SSD): in-proj -> causal conv -> SSD scan -> gated norm ->
out-proj.

The full-sequence form (training, the embedder): the scan is
``kernels/ops.ssd_scan``, the hand-written chunked kernel on the card and
the sequential plain version on the CPU, from a zero state.  The block
is differentiable end to end: the scan's gradient is the gradient kernel
(``ops.ssd_scan``'s autograd function), and the conv (float32 shifted
sums), softplus and the gated RMSNorm are plain PyTorch.

The stateful form (prefill and decode through a cache) carries the conv
state (B, d_conv - 1, conv_ch) and the SSM state (B, H, P, N) in float32
(``init_ssm_state``) and walks the recurrence one step at a time in
plain PyTorch (``_ssd_recurrent``), as the reference does: the kernel
starts from a zero state and returns y only.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.index import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (CausalConv1d, causal_conv1d,
                                       he_init_, param)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return s, d_inner, d_inner // s.head_dim


class SSM(nn.Module):
    """Parameters of one Mamba-2 mixer.  ``a_log``, ``dt_bias`` and
    ``d_skip`` are float32 whatever the config's parameter dtype, as the
    reference keeps them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        s, d_inner, H = _dims(cfg)
        dt = cfg.pdtype
        conv_ch = d_inner + 2 * s.n_groups * s.d_state
        # projects to [z (gate), x, B, C, dt]
        self.w_in = param(cfg.d_model,
                          2 * d_inner + 2 * s.n_groups * s.d_state + H,
                          dtype=dt, device=device)
        self.conv = CausalConv1d(conv_ch, s.d_conv, dt, device)
        self.a_log = param(H, dtype=torch.float32, device=device)
        self.dt_bias = param(H, dtype=torch.float32, device=device)
        self.d_skip = param(H, dtype=torch.float32, device=device)
        self.norm_scale = param(d_inner, dtype=dt, device=device)
        self.w_out = param(d_inner, cfg.d_model, dtype=dt, device=device)

    def reset_parameters(self, generator) -> None:
        """The reference's ``init_ssm``: in/out projections normal /
        sqrt(fan_in), a_log = log(linspace(1, 16, H)), dt_bias 0, d_skip
        1, norm scale 1 (the conv resets itself)."""
        H = self.a_log.shape[0]
        he_init_(self.w_in, generator)
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        self.dt_bias.zero_()
        self.d_skip.fill_(1.0)
        self.norm_scale.fill_(1.0)
        he_init_(self.w_out, generator, fan_in=self.w_out.shape[0])

    def forward(self, x):
        return ssm_block(self, self.cfg, x)


def ssm_block(p, cfg: ModelConfig, xin: torch.Tensor, *, state=None):
    """xin: (B, S, d) -> (B, S, d), the full sequence from a zero state.
    With ``state`` ({"conv": (B, W-1, ch), "ssm": (B, H, P, N)}) the
    sequence continues from it, and the result is (out, new_state)."""
    s, d_inner, H = _dims(cfg)
    B, S, _ = xin.shape
    G, N, P = s.n_groups, s.d_state, s.head_dim

    zxbcdt = xin @ p.w_in
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * G * N, H],
                                 dim=-1)
    xbc, new_conv = causal_conv1d(p.conv, xbc,
                                  None if state is None else state["conv"])
    xbc = F.silu(xbc)
    x, b, c = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    # softplus as jax computes it, log(1 + e^v) everywhere (F.softplus
    # switches to the identity above 20)
    dt = torch.logaddexp(dt_raw.float() + p.dt_bias,
                         torch.zeros((), device=xin.device))   # (B, S, H)

    # views of xbc: the kernel reads them through their strides
    xh = x.view(B, S, H, P)
    bh = b.view(B, S, G, N)
    ch = c.view(B, S, G, N)
    if state is None:
        y = ops.ssd_scan(xh, p.a_log, bh, ch, dt)
    else:
        y, new_ssm = _ssd_recurrent(p, xh, bh, ch, dt, state["ssm"], G, H)
    y = y + xh * p.d_skip[None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, d_inner)

    # gated RMSNorm (Mamba-2), in float32
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + cfg.norm_eps)
    y = (yf * p.norm_scale.float()).to(xin.dtype)
    out = y @ p.w_out
    if state is None:
        return out
    return out, {"conv": new_conv, "ssm": new_ssm}


def _ssd_recurrent(p, xh, bh, ch, dt, ssm_state, G: int, H: int):
    """The stateful recurrence for any S (decode S = 1, a stateful
    prefill S > 1), one step at a time in float32:
    state_t = exp(a dt_t) state_{t-1} + (dt_t x_t) b_t^T, y_t = state_t
    c_t, a = -exp(a_log).  xh (B, S, H, P), bh, ch (B, S, G, N), dt
    (B, S, H), ssm_state (B, H, P, N) float32 (not written).  Returns
    (y (B, S, H, P) in xh's dtype, the new state)."""
    rep = H // G
    bq = bh.float().repeat_interleave(rep, dim=2)            # (B, S, H, N)
    cq = ch.float().repeat_interleave(rep, dim=2)
    a = -torch.exp(p.a_log)
    decay = torch.exp(a * dt)                                # (B, S, H)
    xdt = xh.float() * dt[..., None]                         # (B, S, H, P)
    state = ssm_state.clone()
    ys = []
    with _trips(xh.shape[1], xh) as steps:
        for t in range(steps):
            state.mul_(decay[:, t, :, None, None])
            state.addcmul_(xdt[:, t, :, :, None], bq[:, t, :, None, :])
            ys.append(torch.matmul(state, cq[:, t, :, :, None]))
    if len(ys) == 1:          # the dry run's one step stands for them all
        ys *= xh.shape[1]
    return torch.cat(ys, dim=-1).permute(0, 3, 1, 2).to(xh.dtype), state


def _trips(n: int, like: torch.Tensor):
    """A context giving the steps the recurrence runs: all ``n``, but on
    the meta device under the dry run's counter one, counted n times
    (``launch/op_cost.trips``): the stateful prefill of a 32,768-token
    prompt is one Python step a token."""
    if not like.is_meta:
        return contextlib.nullcontext(n)
    from repro_torch.launch import op_cost
    return op_cost.trips(n, like)


def init_ssm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """A zero state on ``device`` (``cuda`` unless given; raises without a
    card): conv (B, d_conv - 1, conv_ch) in the compute dtype, ssm (B, H,
    P, N) in float32."""
    device = resolve_device(device)
    s, d_inner, H = _dims(cfg)
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch),
                            dtype=cfg.cdtype, device=device),
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }
