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
``_hash``), computed by the hash kernel on the card.  TF32 on the card
would move values across a floor and flip buckets, so importing this
module also turns TF32 off for matmuls and cuDNN.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.core.config import LSHConfig, Scheme
from repro_torch.kernels import lsh_hash as klh

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

    def to(self, device) -> "HashParams":
        return HashParams(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class StackedHashParams:
    """All T tables' ``HashParams`` stacked on a leading table axis (the
    index's canonical form).  ``gather`` selects per-row parameters; the
    index's receive side instead passes each row's table id to
    ``hash_h``/``shard_key``, which read the stacked A in place."""

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

    def as_tables(self) -> list[HashParams]:
        return [self.table(t) for t in range(self.n_tables)]

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


def sample_table_params(key: torch.Tensor,
                        cfg: LSHConfig) -> list[HashParams]:
    """One ``HashParams`` per fused table (length n_tables): entry 0 is
    ``sample_params(key, cfg)``, entry t draws from ``table_key(key, t)``."""
    return [sample_params(table_key(key, t), cfg)
            for t in range(cfg.n_tables)]


def sample_stacked_params(key: torch.Tensor,
                          cfg: LSHConfig) -> StackedHashParams:
    """The stacked form of ``sample_table_params`` (leading T axis)."""
    return StackedHashParams.stack(sample_table_params(key, cfg))


# ---------------------------------------------------------------------------
# First layer H and second layer G: both floor((x a + b) / w), through the
# hash kernel on the card and its plain version on the CPU
# (``kernels/lsh_hash.py``), in one arithmetic: every product rounded once,
# summed in ``tree_sum``'s fixed pairwise order.  A library matmul picks
# its summation order by shape and device, and a flipped floor moves a
# point to another bucket: the insert, the query dispatch and the
# receive-side re-hash must agree exactly, on the CPU and on the card.
#
# Params may be one table (A (d, k)) or stacked (A (T, d, k)): against x
# (n, d) every table hashes every row, (T, n, k); against x (T, ..., d)
# table t hashes x[t].  ``table`` (integer ids covering x's leading dims)
# puts each row under its own table of stacked params instead, without
# gathering A per row.
# ---------------------------------------------------------------------------

def _per_row(v: torch.Tensor, table: torch.Tensor,
             hk: torch.Tensor) -> torch.Tensor:
    """Stacked field v (T, ...) at each row's table, shaped to broadcast
    against hk (*table.shape, ..., k) with its row axis kept."""
    pad = (1,) * (hk.dim() - 1 - table.dim())
    return v[table.to(torch.int64)].reshape(*table.shape, *pad,
                                            *v.shape[1:])


def _hash(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: float,
          table=None, floor: bool = True) -> torch.Tensor:
    """floor((x a + b) / w), or the quotient: a (..., d, k), b (..., k)."""
    if x.dtype not in klh.DTYPES:
        x = x.to(torch.float32)
    if a.dim() == 2 or table is not None:
        return klh.lsh_hash_cuda(x, a, b, w=w, table=table, floor=floor)
    if a.dim() == 3 and x.dim() == 2:
        # every table on every row: the tables' columns side by side
        T, d, k = a.shape
        out = klh.lsh_hash_cuda(x, a.permute(1, 0, 2).reshape(d, T * k),
                                b.reshape(T * k), w=w, floor=floor)
        return out.reshape(-1, T, k).movedim(1, 0)
    # leading dims of params and x broadcast: each batch entry a table
    n, d, k = x.shape[-2], x.shape[-1], a.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-2], a.shape[:-2])
    out = klh.lsh_hash_cuda(
        x.expand(*batch, n, d).reshape(-1, n, d),
        a.expand(*batch, d, k).reshape(-1, d, k),
        b.expand(*batch, k).reshape(-1, k), w=w, floor=floor)
    return out.reshape(*batch, n, k)


def gamma(params: HashParams, x: torch.Tensor, W: float,
          table=None) -> torch.Tensor:
    """Gamma(x) = (x A + b) / W  with shape (..., n, k)."""
    return _hash(x, params.A, params.b, W, table, floor=False)


def hash_h(params: HashParams, x: torch.Tensor, W: float,
           table=None) -> torch.Tensor:
    """H(x) = floor(Gamma(x)) as int32, shape (..., n, k)."""
    return _hash(x, params.A, params.b, W, table)


def pack_buckets(params: HashParams, hk: torch.Tensor,
                 table=None) -> torch.Tensor:
    """Pack (..., n, k) bucket vectors into (..., n, 2) int32 words (the
    bit patterns of the reference's uint32 pair)."""
    hu = as_uint32(hk).unsqueeze(-1)                     # (..., n, k, 1)
    if table is None:
        mult = params.pack_mult.unsqueeze(-3)            # (..., 1, k, 2)
        add = params.pack_add.unsqueeze(-2)              # (..., 1, 2)
    else:
        mult = _per_row(params.pack_mult, table, hk)
        add = _per_row(params.pack_add, table, hk)
    packed = prng.mul_u32(hu, mult).sum(dim=-2)          # < k * 2**32
    packed = (packed + add) & prng.M32
    return to_int32_bits(packed)


# ---------------------------------------------------------------------------
# Second layer G and baselines
# ---------------------------------------------------------------------------

def _second_layer(hk: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                  D: float, table=None) -> torch.Tensor:
    return _hash(hk, alpha.unsqueeze(-1), beta.unsqueeze(-1), D,
                 table).squeeze(-1)


def g_of(params: HashParams, hk: torch.Tensor, D: float,
         table=None) -> torch.Tensor:
    """G(u) = floor((alpha.u + beta)/D) on bucket vectors (..., n, k)."""
    return _second_layer(hk, params.alpha, params.beta, D, table)


def g_cauchy_of(params: HashParams, hk: torch.Tensor, D: float,
                table=None) -> torch.Tensor:
    return _second_layer(hk, params.alpha_cauchy, params.beta, D, table)


def g_sum_of(hk: torch.Tensor) -> torch.Tensor:
    """Haghani et al. 'Sum': the sum of bucket coordinates (int32 wrap)."""
    return to_int32_bits(hk.to(torch.int64).sum(dim=-1) & prng.M32)


# ---------------------------------------------------------------------------
# Scheme dispatch: bucket vector (..., n, k) -> shard key (int32) and shard
# ---------------------------------------------------------------------------

def shard_key(params: HashParams, cfg: LSHConfig, hk: torch.Tensor,
              table=None) -> torch.Tensor:
    """The integer Key whose value determines the machine (paper sec. 3)."""
    if cfg.scheme == Scheme.SIMPLE:
        return pack_buckets(params, hk, table)[..., 0]
    if cfg.scheme == Scheme.LAYERED:
        return g_of(params, hk, float(cfg.D), table)
    if cfg.scheme == Scheme.SUM:
        return g_sum_of(hk)
    if cfg.scheme == Scheme.CAUCHY:
        return g_cauchy_of(params, hk, float(cfg.D), table)
    raise ValueError(f"unknown scheme {cfg.scheme}")


def shard_of(params: HashParams, cfg: LSHConfig, hk: torch.Tensor,
             table=None) -> torch.Tensor:
    """Machine id in [0, n_shards): the Key mod n_shards (floor mod, so
    negative Keys land in range too)."""
    key = shard_key(params, cfg, hk, table)
    return torch.remainder(key, cfg.n_shards).to(torch.int32)


def gh(params: HashParams, cfg: LSHConfig, x: torch.Tensor,
       table=None) -> torch.Tensor:
    """GH(x) for points x (..., n, d) -> int32 Keys (scheme-dependent)."""
    return shard_key(params, cfg, hash_h(params, x, cfg.W, table), table)
