"""LSH hash families (Datar et al. p-stable construction) and the paper's
second-layer Gaussian LSH ``G``, on torch tensors.

First layer:   H(v)   = (h_1(v) .. h_k(v)),  h_i(v) = floor((a_i.v + b_i)/W)
Pre-floor map: Gamma_i(v) = (a_i.v + b_i)/W
Second layer:  G(u)   = floor((alpha.u + beta)/D),  u in R^k  (eq. 3.1)
Cauchy layer:  same as G but alpha ~ standard Cauchy (Haghani et al.)

Bucket identity Z^k -> compact key: two independent 32-bit universal hashes
in uint32 wrap-around arithmetic.  torch lacks uint32 arithmetic, so the
packing runs in int64 masked to 32 bits and the packed words are returned
as their int32 bit pattern (equality of int32 words == equality of
buckets; ORDER must be taken on the uint32 value, see ``as_uint32``).

Every projection is IEEE float32 in a fixed summation order (see
``_project``).  TF32 on the card would move values across a floor and
flip buckets, so importing this module also turns TF32 off for matmuls
and cuDNN.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import prng
from repro_torch.core.config import LSHConfig, Scheme
from repro_torch.kernels.types import tree_sum

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IMAX = 2 ** 31 - 1


def as_uint32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, as int64."""
    return x.to(torch.int64) & prng.M32


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class HashParams:
    """Sampled parameters for one hash table (one H plus one G)."""

    A: torch.Tensor          # (d, k) float32, N(0,1) entries
    b: torch.Tensor          # (k,)   float32, U[0, W)
    alpha: torch.Tensor      # (k,)   float32, N(0,1)   -- layered G
    beta: torch.Tensor       # ()     float32, U[0, D)
    alpha_cauchy: torch.Tensor  # (k,) float32, standard Cauchy
    pack_mult: torch.Tensor  # (k, 2) int64 holding odd uint32 multipliers
    pack_add: torch.Tensor   # (2,)   int64 holding uint32


@dataclasses.dataclass(frozen=True)
class StackedHashParams:
    """All T tables' ``HashParams`` stacked on a leading table axis (the
    index's canonical form).  ``gather`` selects per-row parameters so the
    receive side hashes each routed row once under its own table."""

    A: torch.Tensor          # (T, d, k)
    b: torch.Tensor          # (T, k)
    alpha: torch.Tensor      # (T, k)
    beta: torch.Tensor       # (T,)
    alpha_cauchy: torch.Tensor  # (T, k)
    pack_mult: torch.Tensor  # (T, k, 2)
    pack_add: torch.Tensor   # (T, 2)

    @property
    def n_tables(self) -> int:
        return self.A.shape[0]

    @classmethod
    def stack(cls, tables: list[HashParams]) -> "StackedHashParams":
        if not tables:
            raise ValueError("need at least one table")
        return cls(*(torch.stack([getattr(p, f.name) for p in tables])
                     for f in dataclasses.fields(HashParams)))

    def table(self, t: int) -> HashParams:
        return HashParams(*(getattr(self, f.name)[t]
                            for f in dataclasses.fields(HashParams)))

    def gather(self, tables: torch.Tensor) -> HashParams:
        """(...,) table ids -> HashParams whose fields carry those leading
        dims (row i holds table ``tables[i]``'s parameters)."""
        return HashParams(*(getattr(self, f.name)[tables]
                            for f in dataclasses.fields(HashParams)))

    def to(self, device) -> "StackedHashParams":
        return StackedHashParams(*(getattr(self, f.name).to(device)
                                   for f in dataclasses.fields(self)))


def table_key(key: torch.Tensor, table: int) -> torch.Tensor:
    """RNG key of table ``table``: table 0 uses ``key`` itself (nested
    prefix: raising T never resamples existing tables)."""
    return key if table == 0 else prng.fold_in(key, table)


def sample_params(key: torch.Tensor, cfg: LSHConfig) -> HashParams:
    """One table's parameters from the same key stream as the reference."""
    kA, kb, ka, kB, kc, km, kp = prng.split(key, 7)
    A = prng.normal(kA, (cfg.d, cfg.k))
    b = prng.uniform(kb, (cfg.k,), 0.0, cfg.W)
    alpha = prng.normal(ka, (cfg.k,))
    beta = prng.uniform(kB, (), 0.0, float(cfg.D))
    # standard Cauchy via the inverse CDF of U(0, 1)
    u = prng.uniform(kc, (cfg.k,), 1e-6, 1.0 - 1e-6)
    alpha_cauchy = torch.tan(torch.pi * (u - 0.5))
    mult = prng.randint(km, (cfg.k, 2), 0, IMAX).to(torch.int64)
    pack_mult = (mult * 2 + 1) & prng.M32
    pack_add = prng.randint(kp, (2,), 0, IMAX).to(torch.int64)
    return HashParams(A, b, alpha, beta, alpha_cauchy, pack_mult, pack_add)


def sample_stacked_params(key: torch.Tensor,
                          cfg: LSHConfig) -> StackedHashParams:
    """All T tables, table t drawn from ``table_key(key, t)``."""
    return StackedHashParams.stack(
        [sample_params(table_key(key, t), cfg) for t in range(cfg.n_tables)])


# ---------------------------------------------------------------------------
# First layer H.  Params may carry leading batch dims (one table per row
# after ``gather``): A (..., d, k) against x (..., n, d).
# ---------------------------------------------------------------------------

def _project(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x (..., n, c) times a (..., c, k) -> (..., n, k): every product
    rounded once, then summed over c by ``tree_sum``.  A library matmul
    picks its summation order by shape and device, and a flipped floor
    moves a point to another bucket: the insert, the query dispatch and
    the receive-side re-hash must agree exactly, on the CPU and on the
    card.  The (n, c, k) products are formed a slab of rows at a time."""
    n, c, k = x.shape[-2], x.shape[-1], a.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-2], a.shape[:-2])
    step = max(1, (1 << 24) // max(1, c * k * math.prod(batch)))
    parts = [tree_sum(x[..., i:i + step, :, None] * a[..., None, :, :], -2)
             for i in range(0, n, step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def gamma(params: HashParams, x: torch.Tensor, W: float) -> torch.Tensor:
    """Gamma(x) = (x A + b) / W  with shape (..., n, k)."""
    proj = _project(x.to(torch.float32), params.A)
    return (proj + params.b.unsqueeze(-2)) / torch.tensor(
        W, dtype=torch.float32)


def hash_h(params: HashParams, x: torch.Tensor, W: float) -> torch.Tensor:
    """H(x) = floor(Gamma(x)) as int32, shape (..., n, k)."""
    return torch.floor(gamma(params, x, W)).to(torch.int32)


def pack_buckets(params: HashParams, hk: torch.Tensor) -> torch.Tensor:
    """Pack (..., n, k) bucket vectors into (..., n, 2) int32 words (the
    bit patterns of the reference's uint32 pair)."""
    hu = as_uint32(hk).unsqueeze(-1)                     # (..., n, k, 1)
    mult = params.pack_mult.unsqueeze(-3)                # (..., 1, k, 2)
    packed = prng.mul_u32(hu, mult).sum(dim=-2)          # < k * 2**32
    packed = (packed + params.pack_add.unsqueeze(-2)) & prng.M32
    return to_int32_bits(packed)


# ---------------------------------------------------------------------------
# Second layer G and baselines
# ---------------------------------------------------------------------------

def _second_layer(hk: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                  D: float) -> torch.Tensor:
    proj = _project(hk.to(torch.float32), alpha.unsqueeze(-1)).squeeze(-1)
    proj = proj + beta.unsqueeze(-1)
    return torch.floor(proj / torch.tensor(D, dtype=torch.float32)).to(
        torch.int32)


def g_of(params: HashParams, hk: torch.Tensor, D: float) -> torch.Tensor:
    """G(u) = floor((alpha.u + beta)/D) on bucket vectors (..., n, k)."""
    return _second_layer(hk, params.alpha, params.beta, D)


def g_cauchy_of(params: HashParams, hk: torch.Tensor,
                D: float) -> torch.Tensor:
    return _second_layer(hk, params.alpha_cauchy, params.beta, D)


def g_sum_of(hk: torch.Tensor) -> torch.Tensor:
    """Haghani et al. 'Sum': the sum of bucket coordinates (int32 wrap)."""
    return to_int32_bits(hk.to(torch.int64).sum(dim=-1) & prng.M32)


# ---------------------------------------------------------------------------
# Scheme dispatch: bucket vector (..., n, k) -> shard key (int32) and shard
# ---------------------------------------------------------------------------

def shard_key(params: HashParams, cfg: LSHConfig,
              hk: torch.Tensor) -> torch.Tensor:
    """The integer Key whose value determines the machine (paper sec. 3)."""
    if cfg.scheme == Scheme.SIMPLE:
        return pack_buckets(params, hk)[..., 0]
    if cfg.scheme == Scheme.LAYERED:
        return g_of(params, hk, float(cfg.D))
    if cfg.scheme == Scheme.SUM:
        return g_sum_of(hk)
    if cfg.scheme == Scheme.CAUCHY:
        return g_cauchy_of(params, hk, float(cfg.D))
    raise ValueError(f"unknown scheme {cfg.scheme}")


def shard_of(params: HashParams, cfg: LSHConfig,
             hk: torch.Tensor) -> torch.Tensor:
    """Machine id in [0, n_shards): the Key mod n_shards (floor mod, so
    negative Keys land in range too)."""
    key = shard_key(params, cfg, hk)
    return torch.remainder(key, cfg.n_shards).to(torch.int32)
