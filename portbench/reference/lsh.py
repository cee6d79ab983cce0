"""The plain reference of the Layered-LSH index's answers.

Semantics (Bahmani, Goel, Shinde 2012, Fig 3.2; the index's contract in
``src/repro_torch/core/index.py``): a query q, the ``qid``-th row of its
batch, probes in each of T tables the buckets H_t(q + delta_l) of L
entropy offsets delta_l = r * g / |g|, with g ~ N(0, I_d) drawn from
``fold_in(base_key_t, qid)``.  Its answer is the K stored points, each
counted once, that share a probed bucket in some table, lie within c*r of
q, and come first by (distance, gid).  H_t(x) = floor((x A_t + b_t) / W),
with (A_t, b_t) and the offset base keys derived from the configuration's
seed through the frozen PRNG copy beside this file.  Which shard holds a
row and how rows travel between shards change no answer, so the
reference has neither.

Two precisions:

* ``"exact"`` (the reference): projections and distances in float64 from
  the float32 inputs.  A float32 projection may round a floor the other
  way where the exact value lies within a few ulps of an integer; each
  projection within ``eps`` (``ambiguity_eps``) of one is flagged, so the
  comparison can tell such a flip from a fault.
* ``"tf32"`` (the control): the same arithmetic with every product's
  inputs rounded to TF32 (10 mantissa bits, round to nearest even) and
  float32 sums, the precision a matrix product on the card takes with
  TF32 on; distances as |q|^2 + |p|^2 - 2 q.p.

Everything is plain PyTorch on one device; rows are processed in blocks.
Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference import prng

U = 2.0 ** -24          # float32 unit roundoff
IMAX = 2 ** 31 - 1      # the index's empty gid
_P31 = 2 ** 31 - 1      # modulus of the bucket-key hashes
_HOFF = 2 ** 20         # shifts a bucket coordinate to a positive value
ROW_BLOCK = 1 << 20     # rows hashed at once


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, ties to even)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def cr2_of(cfg: dict) -> float:
    """The squared radius as the index holds it: float32((c r)^2)."""
    return float(np.float32((cfg["c"] * cfg["r"]) ** 2))


@dataclasses.dataclass
class Params:
    """Each table's (A, b) and offset base key."""
    A: torch.Tensor          # (T, d, k) float32
    b: torch.Tensor          # (T, k) float32
    base_keys: torch.Tensor  # (T, 2) int64


def sample_params(cfg: dict, device) -> Params:
    """The configuration's hash parameters, from its seed: the key split
    into (params, offsets); table t's keys are fold_in(key, t) for t > 0;
    (A, b) are the first two of a table key's seven subkeys."""
    d, k, W, T = cfg["d"], cfg["k"], float(cfg["W"]), cfg["n_tables"]
    kp, kq = prng.split(prng.PRNGKey(cfg["seed"]))
    A, b, keys = [], [], []
    for t in range(T):
        key = kp if t == 0 else prng.fold_in(kp, t)
        sub = prng.split(key, 7)
        A.append(prng.normal(sub[0], (d, k)))
        b.append(prng.uniform(sub[1], (k,), 0.0, W))
        keys.append(kq if t == 0 else prng.fold_in(kq, t))
    return Params(torch.stack(A).to(device), torch.stack(b).to(device),
                  torch.stack(keys).to(device))


def ambiguity_eps(d: int) -> float:
    """Relative bound, per unit of sum |x_i a_i| + |b|, on how far the
    index's float32 projection (products rounded once, a pairwise sum,
    + b, / W) and its float32 offsets may lie from the exact value."""
    return (math.ceil(math.log2(max(d, 2))) + 16) * U


class Hasher:
    """H_t of rows and of query probes, in one precision."""

    def __init__(self, cfg: dict, params: Params, precision: str = "exact"):
        if precision not in ("exact", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.cfg, self.p, self.precision = cfg, params, precision
        self.W = float(cfg["W"])
        self.eps = ambiguity_eps(cfg["d"])

    def project(self, x: torch.Tensor, t: int, mag=None):
        """Rows x (n, d) under table t -> (H (n, k) int64, ambiguous (n,)
        bool).  ``mag`` (n, d) bounds |x_i| for the error estimate where x
        itself was rounded from a sum (the offsets)."""
        A, b = self.p.A[t], self.p.b[t]
        if self.precision == "tf32":
            x32 = x.to(torch.float32)
            v = (tf32(x32) @ tf32(A) + b) / torch.tensor(
                self.W, dtype=torch.float32, device=x.device)
            return torch.floor(v).to(torch.int64), torch.zeros(
                x.shape[0], dtype=torch.bool, device=x.device)
        x64, A64, b64 = x.double(), A.double(), b.double()
        v = (x64 @ A64 + b64) / self.W
        m = (x64.abs() if mag is None else mag.double()) @ A64.abs()
        eps = self.eps * (m + b64.abs()) / self.W
        h = torch.floor(v)
        gap = torch.minimum(v - h, h + 1.0 - v)
        return h.to(torch.int64), (gap < eps).any(dim=-1)

    def offsets(self, q: torch.Tensor, qids: torch.Tensor, t: int):
        """Probes of queries q (m, d) with batch rows qids (m,) in table t
        -> (offsets (m, L, d), |q| + |r g / |g|| or None)."""
        L, r = self.cfg["L"], float(self.cfg["r"])
        keys = prng.fold_in(self.p.base_keys[t], qids.to(torch.int64))
        g = prng.normal(keys, (L, q.shape[-1]))             # (m, L, d)
        if self.precision == "tf32":
            norm = prng.sqrt_f32((g * g).sum(-1, keepdim=True))
            o = q[:, None, :] + torch.tensor(
                r, dtype=torch.float32, device=q.device) * (g / norm)
            return o, None
        g64 = g.double()
        step = r * g64 / torch.linalg.vector_norm(g64, dim=-1, keepdim=True)
        q64 = q.double()[:, None, :]
        return q64 + step, q64.abs() + step.abs()


def bucket_key(h: torch.Tensor) -> torch.Tensor:
    """Bucket vectors (..., k) int64 -> one int64 key (two 31-bit
    polynomial hashes side by side); equal buckets give equal keys, and
    the search checks every key match on the whole vector."""
    ka = torch.zeros(h.shape[:-1], dtype=torch.int64, device=h.device)
    kb = torch.zeros_like(ka)
    for j in range(h.shape[-1]):
        v = h[..., j] + _HOFF
        ka = (ka * 1_000_003 + v) % _P31
        kb = (kb * 999_983 + 7 * v + 1) % _P31
    return (ka << 31) | kb


class Store:
    """Every row that is live at some point of a run: row id == gid,
    points ``x`` (N, d) float32 on the device, live from admission
    sequence number ``t_in`` (exclusive) to ``t_out`` (exclusive)."""

    def __init__(self, hasher: Hasher, x: torch.Tensor, t_in: torch.Tensor,
                 t_out: torch.Tensor):
        self.h, self.x = hasher, x
        self.t_in, self.t_out = t_in, t_out
        T = hasher.cfg["n_tables"]
        n = x.shape[0]
        self.H, self.keys, self.order, self.skeys = [], [], [], []
        self.amb = torch.zeros(n, dtype=torch.bool, device=x.device)
        for t in range(T):
            hs, keys = [], []
            for lo in range(0, n, ROW_BLOCK):
                h, a = hasher.project(x[lo:lo + ROW_BLOCK], t)
                self.amb[lo:lo + ROW_BLOCK] |= a
                hs.append(h.to(torch.int32))
                keys.append(bucket_key(h))
            self.H.append(torch.cat(hs))
            k = torch.cat(keys)
            sk, order = torch.sort(k, stable=True)
            self.skeys.append(sk)
            self.order.append(order)

    def live(self, rows: torch.Tensor, seq: int) -> torch.Tensor:
        return (self.t_in[rows] < seq) & (seq < self.t_out[rows])

    def candidates(self, q: torch.Tensor, qids: torch.Tensor, seq: int,
                   cr2: float, slack: float):
        """Rows of the batch's queries q (m, d) that share a probed
        bucket, are live at ``seq`` and lie within cr2 + slack (squared).
        Returns (query index, row, d2 float64) sorted by (query, d2, row),
        and (m,) whether any probe projection of a query is ambiguous."""
        m, d = q.shape
        dev = q.device
        pairs, qamb = [], torch.zeros(m, dtype=torch.bool, device=dev)
        for t in range(len(self.H)):
            o, mag = self.h.offsets(q, qids, t)
            L = o.shape[1]
            h, a = self.h.project(o.reshape(m * L, d), t,
                                  None if mag is None else
                                  mag.reshape(m * L, d))
            qamb |= a.reshape(m, L).any(dim=-1)
            pk = bucket_key(h)
            lo = torch.searchsorted(self.skeys[t], pk, side="left")
            hi = torch.searchsorted(self.skeys[t], pk, side="right")
            cnt = hi - lo
            probe = torch.repeat_interleave(
                torch.arange(m * L, device=dev), cnt)
            first = torch.repeat_interleave(lo - torch.cumsum(cnt, 0) + cnt,
                                            cnt)
            pos = first + torch.arange(probe.numel(), device=dev)
            rows = self.order[t][pos]
            same = (self.H[t][rows].to(torch.int64) == h[probe]).all(dim=-1)
            pairs.append(torch.stack([probe[same] // L, rows[same]]))
        qi, rows = torch.cat(pairs, dim=1)
        n = self.x.shape[0]
        u = torch.unique(qi * n + rows)
        qi, rows = u // n, u % n
        keep = self.live(rows, seq)
        qi, rows = qi[keep], rows[keep]
        d2 = self.d2(q, qi, rows)
        near = d2 <= cr2 + slack
        qi, rows, d2 = qi[near], rows[near], d2[near]
        # sort by (query, d2, row)
        o = torch.argsort(rows, stable=True)
        o = o[torch.argsort(d2[o], stable=True)]
        o = o[torch.argsort(qi[o], stable=True)]
        return (qi[o], rows[o], d2[o]), qamb

    def d2(self, q: torch.Tensor, qi: torch.Tensor, rows: torch.Tensor):
        """Squared distances of pairs (query qi, row) in this precision."""
        if self.h.precision == "tf32":
            a, p = tf32(q[qi]), tf32(self.x[rows])
            return ((a * a).sum(-1) + (p * p).sum(-1)
                    - 2.0 * (a * p).sum(-1)).clamp_min(0.0).double()
        return ((q[qi].double() - self.x[rows].double()) ** 2).sum(-1)


def top_k(cands, m: int, K: int, cr2: float):
    """The reference's answers (m, K) gids (IMAX pad) and d2 (inf pad)
    from ``Store.candidates``: the first K within cr2 per query."""
    qi, rows, d2 = cands
    inside = d2 <= cr2
    qi, rows, d2 = qi[inside], rows[inside], d2[inside]
    gids = torch.full((m, K), IMAX, dtype=torch.int64, device=qi.device)
    dist = torch.full((m, K), float("inf"), dtype=torch.float64,
                      device=qi.device)
    if qi.numel():
        start = torch.searchsorted(qi, qi, side="left")
        rank = torch.arange(qi.numel(), device=qi.device) - start
        sel = rank < K
        gids[qi[sel], rank[sel]] = rows[sel]
        dist[qi[sel], rank[sel]] = d2[sel]
    return gids, dist
