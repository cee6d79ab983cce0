"""Carry the reference index's sampled state across to the port.

The port samples its parameters with its own jax-compatible generator;
``sample_params`` matches jax bitwise except where a normal or ``tan``
draw rounds an ulp apart.  To make the two indexes compute the very same
thing, the reference's arrays themselves can be installed: pass its
``stacked_params`` fields and ``stacked_keys`` as numpy arrays (the port
takes nothing from jax but plain arrays).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import StackedHashParams

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
