"""Entropy-LSH query offsets (Panigrahy, SODA'06), batched over rows.

Offsets q + delta_i, i = 1..L, with delta_i uniform on the *surface* of
the sphere B(q, r): normalised Gaussian directions scaled to radius r.
Every shard must regenerate the same offsets for a query ("choose ...
consistently across Mappers"), so the RNG key is ``fold_in(base_key,
qid)`` of a shared key, drawn with the jax-compatible generator of
``core/prng.py``.  Where the reference vmaps one query at a time, these
functions take a leading batch of rows.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.hashing import table_key
from repro_torch.kernels.types import sq_norms


def offset_directions(keys: torch.Tensor, L: int, d: int) -> torch.Tensor:
    """keys (..., 2) -> (..., L, d) unit vectors, uniform on the sphere."""
    g = prng.normal(keys, (L, d))
    # squared norm summed in a fixed order: the same offsets on every
    # device, so dispatch and receive side hash them alike
    norm = torch.sqrt(sq_norms(g)).unsqueeze(-1)
    return g / torch.clamp_min(norm, 1e-12)


def query_offsets(base_key: torch.Tensor, qids: torch.Tensor,
                  qs: torch.Tensor, L: int, r: float) -> torch.Tensor:
    """(..., L, d) offsets of queries qs (..., d) with global ids qids
    (...,) under one shared base key (2,) or per-row keys (..., 2)."""
    keys = prng.fold_in(base_key, qids)
    dirs = offset_directions(keys, L, qs.shape[-1])
    return qs.unsqueeze(-2) + torch.tensor(r, dtype=torch.float32) * dirs


def stacked_base_keys(base_key: torch.Tensor, n_tables: int) -> torch.Tensor:
    """(T, 2) per-table offset base keys; row t = ``table_key(base, t)``."""
    return torch.stack([table_key(base_key, t) for t in range(n_tables)])


def query_offsets_by_table(base_keys: torch.Tensor, tables: torch.Tensor,
                           qids: torch.Tensor, qs: torch.Tensor,
                           L: int, r: float) -> torch.Tensor:
    """Offsets of routed rows, each under its own table's base key:
    tables/qids (...,), qs (..., d) -> (..., L, d)."""
    return query_offsets(base_keys[tables], qids, qs, L, r)
