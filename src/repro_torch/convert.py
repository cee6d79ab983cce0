"""Carry the reference's sampled state across to the port.

The port samples its index parameters with its own jax-compatible
generator; ``sample_params`` matches jax bitwise except where a normal or
``tan`` draw rounds an ulp apart.  To make the two indexes compute the
very same thing, the reference's arrays themselves can be installed:
pass its ``stacked_params`` fields and ``stacked_keys`` as numpy arrays
(the port takes nothing from jax but plain arrays).

Model weights carry across the same way (``model_params_from_arrays``):
the port draws its own with a ``torch.Generator``, which does not give
jax.random's numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import StackedHashParams
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.transformer import Transformer

FIELDS = ("A", "b", "alpha", "beta", "alpha_cauchy", "pack_mult", "pack_add")


def stacked_params_from_arrays(arrays: dict, device="cpu"
                               ) -> StackedHashParams:
    """``{field: numpy array}`` of the reference's StackedHashParams (uint32
    packing words included) -> the port's StackedHashParams."""
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        if name.startswith("pack"):
            t = torch.as_tensor(a.astype(np.uint32).astype(np.int64))
        else:
            t = torch.as_tensor(a.astype(np.float32))
        out[name] = t.to(device)
    return StackedHashParams(**out)


def keys_from_array(keys, device="cpu") -> torch.Tensor:
    """The reference's (T, 2) uint32 offset base keys -> the port's (T, 2)
    int64 key stack."""
    a = np.asarray(keys).astype(np.uint32).astype(np.int64)
    return torch.as_tensor(a, device=device)


def install(index, params: dict, keys) -> None:
    """Install the reference's parameters and keys into a port index
    (before its store is populated)."""
    index.stacked_params = stacked_params_from_arrays(params, index.device)
    index.stacked_keys = keys_from_array(keys, index.device)


def model_params_from_arrays(tree: dict, cfg: ModelConfig, device=None
                             ) -> Transformer:
    """The reference's ``init_params`` pytree, as numpy arrays, -> the
    port's Transformer holding the same weights.

    ``tree["segments"][i]["b<j>"]`` holds block j of segment i's unit
    with every leaf stacked over the segment's ``repeat`` copies on axis
    0; copy r of block j is the port's layer r * len(kinds) + j of that
    segment.  The tied embedding table doubles as the head; an untied
    config brings ``tree["lm_head"]``.  An ATTN block carries
    ``norm_mix``, ``attn``, ``norm_mlp`` and ``mlp``; an SSM block
    ``norm_mix`` and ``ssm`` (``w_in``, ``conv/{w, b}``, ``a_log``,
    ``dt_bias``, ``d_skip``, ``norm_scale``, ``w_out``) and no MLP.
    ``device`` is ``cuda`` unless given."""
    model = Transformer(cfg, device)

    def put(dst: torch.Tensor, a) -> None:
        a = np.asarray(a)
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"shape {a.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a.astype(np.float32)))

    put(model.embed_table, tree["embed"]["table"])
    put(model.final_norm.scale, tree["final_norm"]["scale"])
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"])
    for seg, blocks, stacked in zip(cfg.segments, model.segments,
                                    tree["segments"]):
        unit = len(seg.kinds)
        for r in range(seg.repeat):
            for j in range(unit):
                p, b = stacked[f"b{j}"], blocks[r * unit + j]
                put(b.norm_mix.scale, p["norm_mix"]["scale"][r])
                if seg.kinds[j] == BlockKind.SSM:
                    s = p["ssm"]
                    for w in ("w_in", "a_log", "dt_bias", "d_skip",
                              "norm_scale", "w_out"):
                        put(getattr(b.ssm, w), s[w][r])
                    put(b.ssm.conv.w, s["conv"]["w"][r])
                    put(b.ssm.conv.b, s["conv"]["b"][r])
                    continue
                put(b.norm_mlp.scale, p["norm_mlp"]["scale"][r])
                for w in ("wq", "wk", "wv", "wo"):
                    put(getattr(b.attn, w), p["attn"][w][r])
                for w in ("w_gate", "w_up", "w_down"):
                    put(getattr(b.mlp, w), p["mlp"][w][r])
    return model
