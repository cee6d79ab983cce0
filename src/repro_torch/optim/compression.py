"""Int8 error-feedback gradient compression (the reference's
``optim/compression.py``): symmetric per-tensor int8 with the residual of
the quantisation carried to the next step.  The int8 values and the scale
are the reference's bit for bit (the same float32 division and rounding,
half to even)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map


class EFState(NamedTuple):
    residual: Any      # same tree as grads, f32


def init(grads_shape) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_shape))


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8, scale). Symmetric per-tensor quantisation."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, ef: EFState):
    """Returns (quantised tree of (q, scale), new_ef, recon tree): recon
    is what every worker sees after the all-reduce of q; the error goes
    into the residual for the next step."""
    def one(g, r):
        gf = g.to(torch.float32) + r
        q, s = quantize(gf)
        recon = dequantize(q, s)
        return (q, s), gf - recon, recon

    flat = tree_map(one, grads, ef.residual)
    pick = lambda i: tree_map(lambda _, t: t[i], grads, flat)
    return pick(0), EFState(residual=pick(1)), pick(2)
