"""Mixture-of-Experts MLP with static-shape sort-based dispatch (the
reference's ``src/repro/models/moe.py``).

Each token picks its top-k experts by a float32 router; the Switch
balance loss comes back beside the output.  Dispatch is the reference's
fixed-capacity pattern: the rank of each (token, choice) within its
expert from a stable sort, slots capped at C per expert, a masked
scatter into an (E, C, d) buffer, the expert products as batched
products over E, and a weighted gather-combine of each token's K slots.
Tokens past an expert's capacity are dropped: their slot is the sink
``E * C`` and they fall back to the residual path (GShard).

The reference splits the tokens into G groups, G = the data-parallel
shards (``pspec.dp()``), and routes within each group.  With no mesh G
is 1 (``src/repro/models/pspec.py:91-92``), and the port has no mesh:
capacity is per call, over all B * S tokens of it.

Every step keeps the reference's dtype: the router and its softmax in
float32, the buffer and the expert products in the compute dtype, the
combine weights cast to it before the sum over K.  Every operation of
the dispatch, the combine and their backward has a deterministic CUDA
implementation (gathers, ``index_put`` without accumulation, sorts), so
a training run under ``torch.use_deterministic_algorithms`` replays bit
for bit.  The expert products are library products, as the reference's
are plain einsums outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

# the router must be IEEE float32: routing is discrete, and a TF32 product
# flips experts.  core.hashing turns TF32 off when imported; importing it
# here means no MoE layer can run before that has taken effect
from repro_torch.core import hashing  # noqa: F401
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, he_init_, param


class Routing(NamedTuple):
    """One call's routing of T tokens to E experts of capacity C."""
    probs: torch.Tensor   # (T, E) float32 router softmax
    top_w: torch.Tensor   # (T, K) float32, renormalised over the K
    top_e: torch.Tensor   # (T, K) int64, each row's experts, best first
    slot: torch.Tensor    # (T * K,) int64 buffer slot, E * C if dropped
    keep: torch.Tensor    # (T * K,) bool, False for a dropped choice
    capacity: int         # C


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert has for a call of ``tokens`` tokens (one group)."""
    m = cfg.moe
    return int(m.capacity_factor * tokens * m.top_k / m.n_experts) + 1


def route(router: torch.Tensor, cfg: ModelConfig, xf: torch.Tensor
          ) -> Routing:
    """Tokens xf (T, d) -> their ``Routing`` (the reference's
    ``moe_mlp`` up to the dispatch): float32 logits and softmax, the
    top-k, the weights renormalised with a 1e-9 floor, and each choice's
    slot by its rank within its expert."""
    m = cfg.moe
    T = xf.shape[0]
    E, K = m.n_experts, m.top_k
    probs = torch.softmax(xf.float() @ router, dim=-1)            # (T, E)
    # top-k ties: jax.lax.top_k puts the lower index first on equal
    # values, and torch.topk promises no order; a stable sort of the
    # negated probabilities keeps index order among equals (a zero row's
    # uniform probabilities route to experts 0 .. K-1)
    top_e = torch.argsort(-probs, dim=-1, stable=True)[:, :K]
    top_w = torch.gather(probs, 1, top_e)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # rank within expert: the stable sort keeps token order among equal
    # experts, as jnp.argsort does (the reference relies on it)
    C = capacity(cfg, T)
    e_row = top_e.reshape(T * K)
    order = torch.argsort(e_row, stable=True)
    esorted = e_row[order]
    starts = torch.searchsorted(esorted, torch.arange(E, device=xf.device))
    rank_sorted = torch.arange(T * K, device=xf.device) - starts[esorted]
    # back to (t, k) order, as the reference's .at[order].set: order is a
    # permutation, so this index_put writes each element once
    rank = torch.empty_like(rank_sorted).index_put_((order,), rank_sorted)
    keep = rank < C
    slot = torch.where(keep, e_row * C + rank, E * C)            # sink slot
    return Routing(probs, top_w, top_e, slot, keep, C)


def balance_loss(r: Routing, n_experts: int) -> torch.Tensor:
    """The Switch balance loss E * sum_e f_e p_e, a 0-d float32 tensor:
    p the mean router probability of each expert, f the share of the
    T * K choices it got (an integer count times 1 / (T * K), no float
    atomics)."""
    T, K = r.top_e.shape
    me = r.probs.mean(dim=0)
    ce = torch.bincount(r.top_e.reshape(-1), minlength=n_experts).float() \
        * (1.0 / (T * K))
    return n_experts * torch.sum(me * ce)


def moe_mlp(p, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux 0-d float32).

    p holds router (d, E) float32, w_gate and w_up (E, d, f), w_down (E,
    f, d) and optionally ``shared``, a gated MLP every token runs."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    cdt = cfg.cdtype
    xf = x.reshape(T, d)
    r = route(p.router, cfg, xf)
    aux = balance_loss(r, E)
    C = r.capacity

    # dispatch: each (token, choice) row into its slot; a dropped row is
    # zero and lands in the sink E * C, which the buffer then leaves out
    rows = xf[:, None].expand(T, K, d).reshape(T * K, d)
    rows = torch.where(r.keep[:, None], rows, 0).to(cdt)
    buf = torch.zeros((E * C + 1, d), dtype=cdt, device=x.device)
    buf = buf.index_put((r.slot,), rows)[:-1].view(E, C, d)

    h = torch.bmm(buf, p.w_gate)                                   # (E,C,f)
    u = torch.bmm(buf, p.w_up)
    act = F.silu(h) if cfg.act == "silu" else F.gelu(h, approximate="tanh")
    out = torch.bmm(act * u, p.w_down).reshape(E * C, d)

    # combine: token t's K outputs sit at its K slots.  Its backward is a
    # scatter-add into the E * C slots, which are unique but for the
    # clamped E * C - 1 of dropped choices, whose gradients are zeros
    safe = torch.clamp(r.slot, max=E * C - 1)
    gathered = torch.where(r.keep[:, None], out.index_select(0, safe), 0)
    w = r.top_w.reshape(T * K, 1).to(gathered.dtype)
    y = (gathered * w).view(T, K, d).sum(dim=1)
    if m.n_shared:
        y = y + p.shared(xf)
    return y.view(B, S, d).to(x.dtype), aux


class MoE(nn.Module):
    """Parameters of ``moe_mlp`` in the reference's layout (``init_moe``):
    router (d, E) float32 whatever the param dtype, w_gate and w_up (E,
    d, f), w_down (E, f, d), and a shared gated MLP of width
    ``d_ff_shared`` (or ``d_ff_expert * n_shared``) where the config has
    shared experts."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        m, d, dt = cfg.moe, cfg.d_model, cfg.pdtype
        E, f = m.n_experts, m.d_ff_expert
        self.router = param(d, E, dtype=torch.float32, device=device)
        self.w_gate = param(E, d, f, dtype=dt, device=device)
        self.w_up = param(E, d, f, dtype=dt, device=device)
        self.w_down = param(E, f, d, dtype=dt, device=device)
        self.shared = (MLP(d, m.d_ff_shared or f * m.n_shared, cfg.act, dt,
                           device) if m.n_shared else None)

    def reset_parameters(self, generator) -> None:
        """The reference's distributions: normal / sqrt(fan_in), fan_in
        the first dimension -- which for w_gate and w_up is E, as the
        reference's ``he_init`` has it -- and f for w_down (the shared
        MLP resets itself)."""
        he_init_(self.router, generator)
        he_init_(self.w_gate, generator)
        he_init_(self.w_up, generator)
        he_init_(self.w_down, generator, fan_in=self.w_down.shape[1])

    def forward(self, x):
        return moe_mlp(self, self.cfg, x)
