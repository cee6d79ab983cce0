"""Carry the reference's sampled state across to the port.

The port samples its index parameters with its own jax-compatible
generator; ``sample_params`` matches jax bitwise except where a normal or
``tan`` draw rounds an ulp apart.  To make the two indexes compute the
very same thing, the reference's arrays themselves can be installed:
pass its ``stacked_params`` fields and ``stacked_keys`` as numpy arrays
(the port takes nothing from jax but plain arrays).

Model weights carry across the same way (``model_params_from_arrays``):
the port draws its own with a ``torch.Generator``, which does not give
jax.random's numbers.  Training state goes both ways: the reference's
``OptState`` into the port (``opt_state_from_arrays``), and the port's
parameters or gradients back to the reference's tree as numpy
(``model_arrays``), so that tests compare leaf by leaf.  A serving
cache crosses both ways too (``cache_from_arrays``, ``cache_arrays``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import StackedHashParams
from repro_torch.core.index import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, init_cache,
                                            load_param_tree, param_tree)
from repro_torch.optim import OptState
from repro_torch.tree import tree_map

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
    ``norm_mix``, ``attn``, ``norm_mlp`` and ``mlp`` -- or, in a MoE
    segment, ``moe`` (``router``, the expert stacks ``w_gate``, ``w_up``,
    ``w_down`` of (E, d, f) / (E, f, d), and ``shared`` where the config
    has shared experts); an MLA block's ``attn`` holds ``w_dkv``,
    ``w_kpe``, ``w_uk``, ``w_uv``, ``wq`` and ``wo``; an SSM block
    ``norm_mix`` and ``ssm`` (``w_in``, ``conv/{w, b}``, ``a_log``,
    ``dt_bias``, ``d_skip``, ``norm_scale``, ``w_out``) and no MLP; an
    RG-LRU block ``rglru`` (``w_x``, ``w_gate_out``, ``conv/{w, b}``,
    ``w_input_gate``, ``w_rec_gate``, ``lam``, ``w_out``) with the norms
    and MLP; a decoder block of an encoder-decoder ``norm_cross`` and
    ``cross`` (``wq``, ``wk``, ``wv``, ``wo``) besides.  The encoder is
    ``tree["encoder"]``: ``segment/b0`` (an ATTN block, every leaf
    stacked over ``encoder_layers``) and ``norm``.  Leaves go through
    float32 and round to each parameter's dtype (an RG-LRU's ``lam``
    stays float32 in a bf16 model).  ``device`` is ``cuda`` unless
    given."""
    model = Transformer(cfg, device)
    load_param_tree(model, _tensors(tree))
    return model


def model_arrays(model: Transformer, values: dict | None = None) -> dict:
    """The model's parameters -- or ``values``, {parameter name: tensor},
    e.g. their gradients -- as the reference's pytree of float32 numpy
    arrays (``param_tree``'s layout: segments stacked over repeats)."""
    return tree_map(lambda t: t.float().cpu().numpy(),
                    param_tree(model, values))


def cache_from_arrays(tree: list, cfg: ModelConfig, device=None) -> list:
    """The reference's ``init_cache`` pytree, as numpy arrays (filled or
    not), -> the port's cache on ``device`` (``cuda`` unless given): the
    same layout (``models.init_cache``: K/V, MLA's latent ckv/kpe, SSM
    and RG-LRU states, the cross-attention's xk/xv), every leaf rounded
    to its dtype.  Batch and Smax are read from the arrays."""
    blocks = [b for seg in tree for b in seg.values()]
    batch = next(iter(blocks[0].values())).shape[1]
    # Smax: axis 3 of K (R, B, Hkv, Smax, hd), axis 2 of MLA's latent ckv
    # (R, B, Smax, kv_lora); an SSM state has none
    smax = next((b["k"].shape[3] if "k" in b else b["ckv"].shape[2]
                 for b in blocks if "k" in b or "ckv" in b), 0)
    cache = init_cache(cfg, batch, smax, device)
    for seg, src in zip(cache, _tensors(tree), strict=True):
        for name, leaves in seg.items():
            for key, t in leaves.items():
                a = src[name][key]
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"{name}/{key}: shape {tuple(a.shape)}"
                                     f" != {tuple(t.shape)}")
                t.copy_(a)
    return cache


def cache_arrays(cache: list) -> list:
    """The port's cache -> the reference's pytree of float32 numpy arrays
    (the inverse of ``cache_from_arrays``), copies that later steps do
    not write."""
    return tree_map(lambda t: t.to("cpu", torch.float32, copy=True).numpy(),
                    cache)


def opt_state_from_arrays(state, device=None) -> OptState:
    """The reference's ``OptState`` as numpy (mu, nu: trees of float32;
    step: int32) -> the port's, on ``device`` (``cuda`` unless given)."""
    device = resolve_device(device)
    mu, nu, step = state
    return OptState(mu=_tensors(mu, device), nu=_tensors(nu, device),
                    step=torch.as_tensor(np.asarray(step, np.int32),
                                         device=device))


def _tensors(tree, device="cpu"):
    """A tree of numpy arrays -> float32 tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device), tree)
