"""AdamW + cosine schedule + global-norm clip, as functions on trees of
tensors (a copy of the reference's ``optim/adamw.py`` arithmetic).

Moments are float32 whatever the parameter dtype: a bf16 parameter is
updated in float32 and rounded once.  ``update`` is functional, like the
reference's: it returns new parameter and moment tensors and leaves its
inputs as they were (the training loop restores a checkpoint into the
same structure after a failure).  Every scalar of the schedule is a
float32 tensor on the step's device, computed in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor      # int32 scalar


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac`` of
    it over ``total_steps``: a float32 scalar."""
    s = step.to(torch.float32)
    warm = torch.clamp((s + 1.0) / float(max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((s - float(cfg.warmup_steps))
                       / float(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, s) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params) -> OptState:
    """Zero float32 moments shaped like ``params`` and step 0."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    first = leaves(params)
    device = first[0].device if first else None
    return OptState(mu=zeros, nu=tree_map(torch.clone, zeros),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's float32
    sum of squares."""
    total = None
    for g in leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def update(cfg: AdamWConfig, grads, state: OptState, params):
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step
    lr = schedule(cfg, step)
    sf = step.to(torch.float32) + 1.0
    b1c = 1 - torch.pow(_f32(cfg.b1, sf), sf)
    b2c = 1 - torch.pow(_f32(cfg.b2, sf), sf)

    def upd(p, g, m, v):
        # pf - lr * (mh / (sqrt(vh) + eps) + wd * pf), mh = m / b1c and
        # vh = v / b2c, with the in-place operations on this function's
        # own temporaries (never on an input): the same roundings, and
        # some four fewer float32 copies of the leaf alive at once (a
        # model of billions of parameters updates near the card's limit)
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        del g
        den = (v / b2c).sqrt_().add_(cfg.eps)
        step_ = (m / b1c).div_(den)
        del den
        pf = p.to(torch.float32)
        step_.add_(cfg.weight_decay * pf).mul_(lr)
        return (pf - step_).to(p.dtype), m, v

    out = tree_map(lambda p, g, m, v: upd(p, g, m, v), params, grads,
                   state.mu, state.nu)
    # out has (p, m, v) triples at the leaves: split them
    pick = lambda i: _pick(out, params, i)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), OptState(pick(1), pick(2), step + 1), metrics


def _pick(out, like, i):
    """Element i of the triples at the leaves of ``out`` (structured like
    ``like``)."""
    return tree_map(lambda _, t: t[i], like, out)
