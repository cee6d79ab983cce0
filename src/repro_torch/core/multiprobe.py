"""Multi-Probe LSH (Lv et al., VLDB'07) -- query-directed probing, batched
over queries.

Instead of Entropy LSH's random sphere offsets, MPLSH probes the buckets
"closest" to the query: each hash coordinate i sits at distance
frac(Gamma_i) from its lower bucket boundary and 1-frac from the upper,
and a perturbation set Delta (coords to shift +-1) is scored by the sum
of those boundary distances.  Probes are the n_probes cheapest sets.

The paper (section 4.2) uses MPLSH as the FIRST layer for the Wiki
dataset and notes (section 5) that Layered LSH composes with it: the
probed bucket vectors are re-hashed through G exactly as with entropy
offsets.  Probes are a deterministic function of the query, so any shard
can regenerate them.

All single-coordinate perturbations plus all pairs among the PAIR_POOL
best singles are enumerated -- the exact algorithm's probe sequence
restricted to |Delta| <= 2.  Gamma comes from the hash kernel's float
quotient on the card (``hashing.gamma``).  Ties in score take the lower
candidate index first (a stable ascending sort, as ``jax.lax.top_k``
orders them); pairs on one coordinate score inf and are still taken once
the finite candidates run out, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.config import LSHConfig
from repro_torch.core.hashing import HashParams, gamma

PAIR_POOL = 8  # pairs drawn from the best 8 single perturbations

# Padding rows when a query has fewer candidate perturbations than
# n_probes.  The sentinel can never equal a real bucket vector (home
# buckets live in a tiny range around 0) and every probe-validity mask
# must exclude it.
SENTINEL = -2 ** 31


def probe_valid_mask(probes: torch.Tensor) -> torch.Tensor:
    """(..., k) probe bucket vectors -> (...) bool, False on sentinel
    padding rows."""
    return probes[..., 0] != SENTINEL


def batch_mplsh_probes(params: HashParams, cfg: LSHConfig,
                       qs: torch.Tensor, n_probes: int) -> torch.Tensor:
    """(m, d) queries -> (m, n_probes + 1, k) int32 probe bucket vectors:
    row 0 the home bucket H(q), then the probes in score order, then
    SENTINEL rows past the candidate pool."""
    k = cfg.k
    dev = qs.device
    m = qs.shape[0]
    g = gamma(params, qs, cfg.W)                         # (m, k)
    home = torch.floor(g).to(torch.int32)
    frac = g - home                                      # in [0, 1)

    # the 2k single-coordinate perturbations: shift -1, then +1
    single_scores = torch.cat([frac, 1.0 - frac], dim=1)       # (m, 2k)
    single_delta = torch.cat([-torch.ones(k, dtype=torch.int32),
                              torch.ones(k, dtype=torch.int32)]).to(dev)
    single_coord = torch.cat([torch.arange(k), torch.arange(k)]).to(dev)

    # pair candidates among the PAIR_POOL best singles
    pool = min(PAIR_POOL, 2 * k)
    top_i = torch.argsort(single_scores, dim=1, stable=True)[:, :pool]
    top_s = torch.gather(single_scores, 1, top_i)
    pi, pj = torch.triu_indices(pool, pool, 1, device=dev)
    pair_scores = top_s[:, pi] + top_s[:, pj]
    # pairs touching the same coordinate twice
    same = single_coord[top_i[:, pi]] == single_coord[top_i[:, pj]]
    pair_scores = torch.where(same, torch.inf, pair_scores)

    all_scores = torch.cat([single_scores, pair_scores], dim=1)
    n_take = min(n_probes, all_scores.shape[1])
    order = torch.argsort(all_scores, dim=1, stable=True)[:, :n_take]

    # each probe shifts one coordinate (a single) or two (a pair)
    is_pair = order >= 2 * k
    p = torch.where(is_pair, order - 2 * k, 0)
    first = torch.where(is_pair, torch.gather(top_i, 1, pi[p]), order)
    second = torch.gather(top_i, 1, pj[p])
    shift = torch.zeros((m, n_take, k), dtype=torch.int32, device=dev)
    shift.scatter_add_(2, single_coord[first][..., None],
                       single_delta[first][..., None])
    shift.scatter_add_(2, single_coord[second][..., None],
                       torch.where(is_pair, single_delta[second], 0)[..., None])
    out = torch.cat([home[:, None], home[:, None] + shift], dim=1)
    if n_take < n_probes:                                # sentinel padding
        pad = torch.full((m, n_probes - n_take, k), SENTINEL,
                         dtype=torch.int32, device=dev)
        out = torch.cat([out, pad], dim=1)
    return out


def mplsh_probes(params: HashParams, cfg: LSHConfig, q: torch.Tensor,
                 n_probes: int) -> torch.Tensor:
    """Probe bucket vectors for one query q (d,): (n_probes + 1, k)."""
    return batch_mplsh_probes(params, cfg, q[None], n_probes)[0]
