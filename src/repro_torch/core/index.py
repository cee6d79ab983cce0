"""Distributed LSH index on one card: the paper's Figure 3.1/3.2 in torch.

The reference runs one shard per device of a JAX mesh and exchanges rows
with ``all_to_all``.  Here the S logical shards are a leading tensor axis
on one device, and the exchange is an exact block transpose of an
(S, S, C, w) buffer: ``recv[j, s] = send[s, j]``.  Every exchange goes
through one counting shim (``AllToAll``), so the collective budgets of
the reference hold and are tested: 1 per insert, 2 per query (dispatch
and routed return), 0 per delete.

The index hosts ``cfg.n_tables`` (T) hash tables fused into one routed
store, exactly as the reference does:

  insert: every point ships T rows (GH_t(p), <H_t(p), p, gid, t>) in one
          fused exchange and lands in free slots of the destination
          shard's append region (tombstoned slots are reused);
  delete: owning shards tombstone all T copies of each gid;
  query:  every query ships one row per distinct Key per table; the
          receiving shard regenerates the offsets from (qid, table),
          keeps the probes whose Key it owns, scans its store for
          bucket-equal same-table points within cr, merges per qid
          across tables, and one routed exchange returns each qid's
          local top-K to its owner shard, which merges the S lists.

The store is LSM-style: a bucket-sorted CSR region ``[0, n_sorted)``
written by ``load_rows`` (``compact``, the auto-merge) and an unsorted
insert tail, scanned by the CSR gather and the full-scan kernels.

Traps carried over from the reference: every argsort that the reference
relies on being stable passes ``stable=True``; every two-key sort is one
sort on a 64-bit key whose order is the lex order; packed bucket words
are ordered as uint32.  Host syncs: an insert and a delete read their
counts back and a query reads its answers back; the scan itself stays on
the device.  The store is updated in place.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng, store_layout
from repro_torch.core.config import LSHConfig, Scheme
from repro_torch.core.hashing import (HashParams, StackedHashParams, hash_h,
                                      pack_buckets, sample_stacked_params,
                                      shard_key)
from repro_torch.core.offsets import (query_offsets, query_offsets_by_table,
                                      stacked_base_keys)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.types import QueryBatch, StoreView, sq_norms

INF = kref.F32_MAX
IMAX = kref.IMAX


def resolve_device(device=None) -> torch.device:
    """The index's device: ``cuda`` unless the caller names one.  There is
    no fallback: asking for the card on a machine without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "index on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Dense dispatch, batched over a leading shard axis
# ---------------------------------------------------------------------------

def dispatch_slots(dest: torch.Tensor, valid: torch.Tensor, n_shards: int,
                   capacity: int):
    """Send-buffer slots for each row of each source shard.

    Args:
      dest: (B, N) destination shard per row;  valid: (B, N) bool.
    Returns:
      slot (B, N) int64 position in the (S*C,) buffer (S*C when dropped),
      keep (B, N) bool rows that fit, drops (B,) live rows past capacity.
    Rows keep their order within a destination (stable sort).
    """
    B, N = dest.shape
    big = torch.where(valid, dest.to(torch.int64), n_shards)
    order = torch.argsort(big, dim=-1, stable=True)
    dsorted = torch.gather(big, -1, order)
    bounds = torch.arange(n_shards + 1, device=dest.device).expand(B, -1)
    starts = torch.searchsorted(dsorted.contiguous(), bounds.contiguous())
    rank_sorted = (torch.arange(N, device=dest.device)
                   - torch.gather(starts, -1, dsorted))
    rank = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    keep = valid & (rank < capacity)
    slot = torch.where(keep, dest.to(torch.int64) * capacity + rank,
                       n_shards * capacity)
    drops = (valid & ~keep).sum(dim=-1)
    return slot, keep, drops


def scatter_rows(slot: torch.Tensor, keep: torch.Tensor, rows: torch.Tensor,
                 n_slots: int, fill) -> torch.Tensor:
    """Scatter (B, N, w) rows into a (B, n_slots, w) buffer (drops go to a
    sink slot that is cut off)."""
    B, _, w = rows.shape
    buf = torch.full((B, n_slots + 1, w), fill, dtype=rows.dtype,
                     device=rows.device)
    buf.scatter_(1, slot[..., None].expand(-1, -1, w),
                 torch.where(keep[..., None], rows, fill))
    return buf[:, :n_slots]


def first_occurrence_mask(keys: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """True on the FIRST live row of each key value, in index order, per
    leading batch row (stable sort, so ties resolve by index)."""
    big = torch.where(valid, keys.to(torch.int64), IMAX)
    order = torch.argsort(big, dim=-1, stable=True)
    s = torch.gather(big, -1, order)
    first_sorted = torch.ones_like(s, dtype=torch.bool)
    first_sorted[..., 1:] = s[..., 1:] != s[..., :-1]
    first = torch.empty_like(first_sorted).scatter_(-1, order, first_sorted)
    return first & valid


def check_gid_range(gids: np.ndarray) -> None:
    """Reject gids outside [0, IMAX): IMAX marks empty/tombstoned slots."""
    if gids.size and (int(gids.min()) < 0 or int(gids.max()) >= IMAX):
        raise ValueError(
            f"gids must lie in [0, {IMAX}): values >= the int32 "
            f"sentinel IMAX (or negative) alias empty-slot/batch padding")


def merge_topk(cand_d: torch.Tensor, cand_g: torch.Tensor, k: int):
    """(..., C) masked (dist, gid) candidates -> the k best per row with
    gid dedup: sort by (gid, dist), blank repeated gids, keep the k best
    by (dist, gid).  Sentinel (INF, IMAX) pairs are fixed points."""
    dbits = cand_d.contiguous().view(torch.int32).to(torch.int64)
    by_gid, _ = torch.sort((cand_g.to(torch.int64) << 32) | dbits, dim=-1)
    sg = (by_gid >> 32).to(torch.int32)
    sd = (by_gid & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    dup = torch.zeros_like(sg, dtype=torch.bool)
    dup[..., 1:] = sg[..., 1:] == sg[..., :-1]
    sd = torch.where(dup, INF, sd)
    sg = torch.where(dup, IMAX, sg)
    return kref.lex_unkey(kref.merge_lex_topk(kref.lex_key(sd, sg), k))


class AllToAll:
    """The cross-shard exchange: (S, S*C, w) send blocks -> (S, S*C, w)
    receive blocks with ``recv[j, s*C:(s+1)*C] = send[s, j*C:(j+1)*C]``
    (the reference's tiled ``all_to_all``).  Counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, send: torch.Tensor) -> torch.Tensor:
        S = send.shape[0]
        C = send.shape[1] // S
        self.calls += 1
        blocks = send.reshape((S, S, C) + tuple(send.shape[2:]))
        return blocks.transpose(0, 1).reshape(send.shape)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _i2f(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.float32)


# ---------------------------------------------------------------------------
# Streaming store and results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StoreState:
    """Per-shard routed append regions (leading dim = shard).

    Slots ``[0, n_sorted)`` of every shard are the sorted CSR region,
    ``[n_sorted, cap)`` the unsorted insert tail (see the reference's
    StoreState for the full contract).  ``packed`` holds the uint32
    bucket words as int32 bit patterns.  ``psq`` caches each row's
    squared norm (``sq_norms``), so a query does not recompute it for
    the whole store.
    """
    x: torch.Tensor             # (S, cap, d) float32 stored points
    packed: torch.Tensor        # (S, cap, 2) int32 packed H buckets
    gid: torch.Tensor           # (S, cap) int32 global ids (IMAX = empty)
    table: torch.Tensor         # (S, cap) int32 table id of each row
    key: torch.Tensor           # (S, cap) int32 routing Key
    valid: torch.Tensor         # (S, cap) bool liveness
    bucket_start: torch.Tensor  # (S, cap) int32 CSR span start
    bucket_end: torch.Tensor    # (S, cap) int32 CSR span end
    psq: torch.Tensor           # (S, cap) float32 squared norms
    n_sorted: int = 0

    @property
    def capacity(self) -> int:
        return self.x.shape[1]

    @classmethod
    def empty(cls, S: int, capacity: int, d: int, device) -> "StoreState":
        """Empty per-shard append regions (all tail)."""
        row = {"x": (d,), "packed": (2,)}
        return cls(**{f: torch.full((S, capacity) + row.get(f, ()), fill,
                                    dtype=dtype, device=device)
                      for f, (dtype, fill) in _COLUMNS.items()}, n_sorted=0)

    @classmethod
    def from_columns(cls, cols: dict, n_sorted: int) -> "StoreState":
        return cls(**cols, n_sorted=n_sorted)

    def grown(self, capacity: int) -> "StoreState":
        """Every shard's tail extended to ``capacity`` empty slots (the
        sorted prefix and its CSR columns are untouched)."""
        def pad(f):
            a = getattr(self, f)
            dtype, fill = _COLUMNS[f]
            shape = (a.shape[0], capacity - a.shape[1]) + tuple(a.shape[2:])
            return torch.cat([a, torch.full(shape, fill, dtype=dtype,
                                            device=a.device)], dim=1)
        return dataclasses.replace(self, **{f: pad(f) for f in _COLUMNS})


# dtype and empty-slot fill of every store column
_COLUMNS = {"x": (torch.float32, 0.0), "packed": (torch.int32, 0),
            "gid": (torch.int32, IMAX), "table": (torch.int32, 0),
            "key": (torch.int32, 0), "valid": (torch.bool, False),
            "bucket_start": (torch.int32, 0), "bucket_end": (torch.int32, 0),
            "psq": (torch.float32, 0.0)}


@dataclasses.dataclass
class BuildResult:
    store_x: torch.Tensor
    store_packed: torch.Tensor
    store_gid: torch.Tensor
    store_table: torch.Tensor
    store_key: torch.Tensor
    store_valid: torch.Tensor
    data_load: np.ndarray     # (S,) live rows stored per shard
    drops: int                # capacity overflow (must be 0)


@dataclasses.dataclass
class InsertResult:
    shard_load: np.ndarray    # (S,) live rows per shard after the insert
    drops: int                # dispatch + append-region overflow
    n_inserted: int           # points stored this call (table-0 copies)
    rows_stored: int          # routed rows stored (n_inserted * T if clean)
    capacity: int             # per-shard append-region capacity
    gid_start: Optional[int]  # minimum gid of this batch (None if empty)


@dataclasses.dataclass
class DeleteResult:
    n_deleted: int            # rows tombstoned across all shards/tables
    n_points: int             # distinct requested gids with >= 1 live row
    shard_load: np.ndarray    # (S,) live rows remaining per shard


@dataclasses.dataclass
class CompactResult:
    capacity_before: int
    capacity_after: int
    n_live: int
    shard_load: np.ndarray


@dataclasses.dataclass
class QueryResult:
    topk_dist: np.ndarray     # (m, K) ascending distances within cr (inf pad)
    topk_gid: np.ndarray      # (m, K) matching global ids (IMAX pad)
    n_within_cr: np.ndarray   # (m,) candidates emitted within cr
    fq: np.ndarray            # (m,) rows shipped per query (Definition 7)
    query_load: np.ndarray    # (S,) live rows received per shard
    drops: int

    @property
    def k_neighbors(self) -> int:
        return self.topk_dist.shape[1]

    @property
    def best_dist(self) -> np.ndarray:
        """(m,) nearest returned distance -- the old best-1 view.

        .. deprecated:: use ``topk_dist[:, 0]`` instead.
        """
        warnings.warn("QueryResult.best_dist is deprecated; use "
                      "topk_dist[:, 0]", DeprecationWarning, stacklevel=2)
        return self.topk_dist[:, 0]

    @property
    def best_gid(self) -> np.ndarray:
        """(m,) nearest returned gid -- the old best-1 view.

        .. deprecated:: use ``topk_gid[:, 0]`` instead.
        """
        warnings.warn("QueryResult.best_gid is deprecated; use "
                      "topk_gid[:, 0]", DeprecationWarning, stacklevel=2)
        return self.topk_gid[:, 0]


@dataclasses.dataclass
class DispatchedBatch:
    """Device-resident output of ``query_dispatch`` (stage 1 of 3).

    ``recv`` is the post-exchange routed payload: each shard's (S*Cq,
    d+2) int32 block of [q | qid | table] rows.  ``query_scan`` reads it.
    """
    recv: torch.Tensor        # (S, S*Cq, d+2) routed int32 payload
    fq: torch.Tensor          # (S, m/S) rows shipped per query
    drops: torch.Tensor       # (S,) capacity drops per source shard
    m: int
    Cq: int


@dataclasses.dataclass
class ScannedBatch:
    """Device-resident output of ``query_scan`` (stage 2 of 3).

    ``ret`` holds each shard's local per-qid top-K (bitcast distances,
    gids, emit count): the routed return payload ``query_return`` reads.
    """
    ret: torch.Tensor         # (S, m, 2K+1) int32 return payload
    recv_load: torch.Tensor   # (S,) live rows received per shard
    m: int
    K: int


def _host_query_result(gtopd, gtopg, gemit, fq, load, drops) -> QueryResult:
    """The answers on the host, fetched in one copy of int32 words."""
    m, K = gtopg.shape
    S = load.shape[0]
    # host-sync: query-answers
    words = torch.cat([
        _f2i(gtopd).reshape(-1), gtopg.reshape(-1), gemit.reshape(-1),
        fq.reshape(-1).to(torch.int32), load.to(torch.int32),
        drops.sum().to(torch.int32).reshape(1)]).cpu().numpy()
    cut = np.cumsum([m * K, m * K, m, m, S])
    d2, gid, emit, fq_h, load_h, drops_h = np.split(words, cut)
    d2 = d2.view(np.float32).reshape(m, K)
    return QueryResult(
        topk_dist=np.sqrt(np.where(d2 < np.float32(3e38), d2, np.inf)),
        topk_gid=gid.reshape(m, K),
        n_within_cr=emit,
        fq=fq_h.astype(np.int64),
        query_load=load_h.astype(np.int64),
        drops=int(drops_h[0]))


class DistributedLSHIndex:
    """T fused hash tables of the paper's scheme over S shards.

    ``device`` defaults to ``cuda``; on ``cuda`` the per-shard scan
    launches the hand-written kernels, on ``cpu`` it runs their plain
    versions.  ``k_neighbors`` is the default K of ``query``.
    ``use_csr=False`` pins the scan to the full-scan kernel even on a
    bucket-sorted store (the comparison baseline; answers are bitwise
    equal either way).  ``merge_min_rows``/``merge_frac`` set the LSM
    merge policy: after an insert, once the unsorted tail holds more than
    ``merge_min_rows`` live rows AND more than ``merge_frac`` of all live
    rows, the tail is folded into the sorted region.
    """

    def __init__(self, cfg: LSHConfig, device=None, slack: float = 4.0,
                 k_neighbors: int = 1, use_csr: bool = True,
                 merge_min_rows: int = 1024, merge_frac: float = 0.25):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slack = slack
        self.use_csr = use_csr
        self.merge_min_rows = merge_min_rows
        self.merge_frac = merge_frac
        if not 1 <= k_neighbors <= 128:
            raise ValueError(f"k_neighbors={k_neighbors} not in [1, 128]")
        self.k_neighbors = k_neighbors
        # sampled on the CPU and moved: the same bits on every device
        kp, kq = prng.split(prng.PRNGKey(cfg.seed))
        self._stacked_params = sample_stacked_params(kp, cfg).to(self.device)
        self._stacked_keys = stacked_base_keys(kq, cfg.n_tables).to(
            self.device)
        # the root offset key (the stacked keys derive from it); kept for
        # snapshots, as the reference keeps it
        self.base_key = kq.to(self.device)
        self.a2a = AllToAll()
        self.store: Optional[StoreState] = None
        self._shard_load = np.zeros((cfg.n_shards,), np.int64)
        self._drops = 0
        self._n_live = 0
        self._next_gid = 0
        self._used = 0            # high-water mark: slots [used, cap) of
        #                           every shard were never written
        self._sorted_live = 0
        self._tail_live = 0
        self._merges = 0
        self._max_bucket = 0
        self._mean_bucket = 0.0

    # ------------------------------------------------------------------
    # Hash parameters (stacked (T, ...) form); replaceable only before the
    # store is populated
    # ------------------------------------------------------------------
    @property
    def stacked_params(self) -> StackedHashParams:
        return self._stacked_params

    @stacked_params.setter
    def stacked_params(self, sparams: StackedHashParams) -> None:
        if sparams.n_tables != self.cfg.n_tables:
            raise ValueError(f"need {self.cfg.n_tables} tables, "
                             f"got {sparams.n_tables}")
        if self.store is not None:
            raise RuntimeError("cannot replace table params on a populated "
                               "index -- assign before build()/insert()")
        self._stacked_params = sparams.to(self.device)

    @property
    def stacked_keys(self) -> torch.Tensor:
        return self._stacked_keys

    @stacked_keys.setter
    def stacked_keys(self, keys: torch.Tensor) -> None:
        if keys.shape != (self.cfg.n_tables, 2):
            raise ValueError(f"need ({self.cfg.n_tables}, 2) keys, "
                             f"got {tuple(keys.shape)}")
        if self.store is not None:
            raise RuntimeError("cannot replace offset keys on a populated "
                               "index -- assign before build()/insert()")
        self._stacked_keys = keys.to(self.device)

    @property
    def params(self) -> HashParams:
        """Table 0's parameters (the single-table view)."""
        return self._stacked_params.table(0)

    @property
    def table_params(self) -> list[HashParams]:
        """.. deprecated:: use ``stacked_params`` (``.as_tables()`` /
        ``.table(t)`` for per-table views)."""
        warnings.warn(
            "DistributedLSHIndex.table_params is deprecated; use "
            "stacked_params.as_tables()", DeprecationWarning, stacklevel=2)
        return self.stacked_params.as_tables()

    @table_params.setter
    def table_params(self, tables) -> None:
        warnings.warn(
            "assigning DistributedLSHIndex.table_params is deprecated; "
            "assign stacked_params = StackedHashParams.stack(tables)",
            DeprecationWarning, stacklevel=2)
        self.stacked_params = StackedHashParams.stack(list(tables))

    @property
    def table_keys(self) -> list[torch.Tensor]:
        """.. deprecated:: use ``stacked_keys`` (a (T, 2) key stack)."""
        warnings.warn(
            "DistributedLSHIndex.table_keys is deprecated; use "
            "stacked_keys", DeprecationWarning, stacklevel=2)
        return [self._stacked_keys[t] for t in range(self.cfg.n_tables)]

    @table_keys.setter
    def table_keys(self, keys) -> None:
        warnings.warn(
            "assigning DistributedLSHIndex.table_keys is deprecated; "
            "assign stacked_keys = torch.stack(keys)",
            DeprecationWarning, stacklevel=2)
        self.stacked_keys = torch.stack(list(keys))

    # ------------------------------------------------------------------
    # Capacity policy (as the reference)
    # ------------------------------------------------------------------
    def _dispatch_capacity(self, n_rows: int) -> int:
        """Per-(source, dest) exchange block capacity for one insert of
        ``n_rows`` routed rows per source shard: slack-share sizing for
        bulk builds, doubled and clamped at n_rows for small batches."""
        if self.cfg.data_capacity is not None:
            return self.cfg.data_capacity
        S = self.cfg.n_shards
        base = max(8, int(math.ceil(n_rows / S * self.slack)))
        if n_rows > 64 * S:
            return base
        return min(n_rows, 2 * base)

    def _store_capacity(self, n_rows: int) -> int:
        S = self.cfg.n_shards
        return max(8, int(math.ceil(n_rows / S * self.slack)))

    def _query_capacity(self, m_local: int) -> int:
        if self.cfg.query_capacity is not None:
            return self.cfg.query_capacity
        S = self.cfg.n_shards
        rows = m_local * self.cfg.pairs_per_query()
        return max(8, int(math.ceil(rows / S * self.slack)))

    # ------------------------------------------------------------------
    # Store lifecycle
    # ------------------------------------------------------------------
    def init_store(self, capacity: int) -> StoreState:
        """Allocate empty per-shard append regions (all tail)."""
        S = self.cfg.n_shards
        self.store = StoreState.empty(S, capacity, self.cfg.d, self.device)
        self._shard_load = np.zeros((S,), np.int64)
        self._drops = 0
        self._n_live = 0
        self._used = 0
        self._sorted_live = 0
        self._tail_live = 0
        self._max_bucket = 0
        self._mean_bucket = 0.0
        return self.store

    # ------------------------------------------------------------------
    # Insert: T rows per point through ONE fused exchange into free tail
    # slots of the table-tagged append regions
    # ------------------------------------------------------------------
    def insert(self, points, gids=None) -> InsertResult:
        """Stream a batch of points (n, d) into the routed store."""
        cfg, dev = self.cfg, self.device
        points = torch.as_tensor(points, dtype=torch.float32, device=dev)
        n, d = points.shape
        if d != cfg.d:
            raise ValueError(f"points d={d} != cfg.d={cfg.d}")
        if gids is None:
            if n and self._next_gid + n - 1 >= IMAX:
                raise ValueError(
                    f"auto-gid space exhausted: this batch would assign "
                    f"gids up to {self._next_gid + n - 1} >= the int32 "
                    f"sentinel {IMAX}; pass explicit in-range gids")
            gid_start = self._next_gid if n else None
            g = torch.arange(self._next_gid, self._next_gid + n,
                             dtype=torch.int32, device=dev)
            self._next_gid += n
        else:
            g64 = np.asarray(gids, np.int64).reshape(-1)
            check_gid_range(g64)
            g = torch.as_tensor(g64.astype(np.int32), device=dev)
            gid_start = int(g64.min()) if n else None
            if n:
                self._next_gid = max(self._next_gid, int(g64.max()) + 1)
        return self._insert(points, g, gid_start)

    def _insert(self, points: torch.Tensor, g: torch.Tensor,
                gid_start: Optional[int]) -> InsertResult:
        """The insert's device work, after its arguments were checked:
        points (n, d) and gids (n,) int32 on the index's device."""
        cfg = self.cfg
        S, T, dev = cfg.n_shards, cfg.n_tables, self.device
        n, d = points.shape
        if self.store is None:
            self.init_store(self._store_capacity(n * T))
        else:
            # the sorted region's slots are unavailable to inserts, so a
            # sorted store sizes the TAIL for the incoming rows on top of
            # the fixed region width
            needed = self.store.n_sorted + self._store_capacity(
                self._tail_live + n * T) if self.store.n_sorted else \
                self._store_capacity(self._n_live + n * T)
            if needed > self.store.capacity:
                self.store = self.store.grown(
                    max(needed, 2 * self.store.capacity))
        st = self.store
        cap, ns = st.capacity, st.n_sorted

        n_pad = int(math.ceil(n / S)) * S if n else S
        pad = n_pad - n
        x = torch.cat([points, points.new_zeros((pad, d))]) if pad \
            else points
        g = torch.cat([g, g.new_full((pad,), IMAX)]) if pad else g
        n_loc = n_pad // S
        valid = (torch.arange(n_pad, device=dev) < n).reshape(S, n_loc)
        Ci = self._dispatch_capacity(n_loc * T)

        # ---- hash: T routed copies per point in one batched pass,
        # point-major row order (table t of point i at row i*T + t) ----
        sp = self.stacked_params
        hk = hash_h(sp, x, cfg.W)                          # (T, n_pad, k)
        packed = pack_buckets(sp, hk)                      # (T, n_pad, 2)
        keys = shard_key(sp, cfg, hk)                      # (T, n_pad)
        nr = n_loc * T
        packed = packed.reshape(T, S, n_loc, 2).permute(1, 2, 0, 3).reshape(
            S, nr, 2)
        rows_k = keys.reshape(T, S, n_loc).permute(1, 2, 0).reshape(S, nr)
        dest = torch.remainder(rows_k, S)
        rows_x = x.reshape(S, n_loc, d).repeat_interleave(T, dim=1)
        rows_g = g.reshape(S, n_loc).repeat_interleave(T, dim=1)
        rows_t = torch.arange(T, dtype=torch.int32, device=dev).repeat(
            n_loc).expand(S, nr)
        rows_v = valid.repeat_interleave(T, dim=1)
        slot, keep, d_drops = dispatch_slots(dest, rows_v, S, Ci)

        # ---- ONE fused exchange: [x | packed | gid | table | key] as a
        # single int32 payload (table < 0 marks empty slots) ----
        payload = torch.cat([_f2i(rows_x), packed, rows_g[..., None],
                             rows_t[..., None], rows_k[..., None]], dim=-1)
        r = self.a2a(scatter_rows(slot, keep, payload, S * Ci, -1))
        rt = r[..., d + 3]
        rv = rt >= 0

        # ---- append into free TAIL slots, in slot order (tail tombstones
        # are reused; sorted-region slots are off limits) ----
        blocked = st.valid | (torch.arange(cap, device=dev) < ns)
        n_free = (~blocked).sum(dim=-1, keepdim=True)
        free_order = torch.argsort(blocked.to(torch.int8), dim=-1,
                                   stable=True)
        rank = torch.cumsum(rv, dim=-1) - 1
        fit = rv & (rank < n_free)
        s_drops = (rv & ~fit).sum(dim=-1)
        target = torch.gather(free_order, -1, torch.clamp(rank, 0, cap - 1))
        # host-sync: insert-fitted-rows
        si, ri = torch.nonzero(fit, as_tuple=True)
        ti = target[si, ri]
        rows = r[si, ri]                                   # (n_fit, d+5)
        rx = _i2f(rows[:, :d])
        st.x[si, ti] = rx
        st.psq[si, ti] = sq_norms(rx)
        st.packed[si, ti] = rows[:, d:d + 2]
        st.gid[si, ti] = rows[:, d + 2]
        st.table[si, ti] = rows[:, d + 3]
        st.key[si, ti] = rows[:, d + 4]
        # a device value: a Python True would be copied to the card first,
        # a host sync
        st.valid[si, ti] = torch.ones_like(ti, dtype=torch.bool)
        if ti.numel():
            # host-sync: insert-high-water
            self._used = max(self._used, int(ti.max()) + 1)

        # host-sync: insert-stats
        stats = torch.stack([
            st.valid.sum(dim=-1), fit.sum(dim=-1),
            (fit & (rt == 0)).sum(dim=-1), d_drops + s_drops]).cpu().numpy()
        load = stats[0].astype(np.int64)
        rows_stored, n_stored = int(stats[1].sum()), int(stats[2].sum())
        n_drops = int(stats[3].sum())
        self._shard_load = load
        self._drops += n_drops
        self._n_live += rows_stored
        self._tail_live += rows_stored
        result = InsertResult(shard_load=load, drops=n_drops,
                              n_inserted=n_stored, rows_stored=rows_stored,
                              capacity=cap, gid_start=gid_start)
        # LSM churn threshold: fold an eroding tail back into the sorted
        # region (only once a region exists)
        if (self.store.n_sorted > 0
                and self._tail_live > self.merge_min_rows
                and self._tail_live > self.merge_frac * max(self._n_live, 1)):
            self.merge_tail()
        return result

    # ------------------------------------------------------------------
    # Delete: tombstone every table's copy of each gid (no exchange)
    # ------------------------------------------------------------------
    def delete(self, gids) -> DeleteResult:
        """Tombstone the given global ids (missing ids are ignored)."""
        if self.store is None:
            raise RuntimeError("insert() or build() first")
        gids = np.asarray(gids, np.int64).reshape(-1)
        check_gid_range(gids)
        return self._delete(np.unique(gids).astype(np.int32))

    def _delete(self, want_host: np.ndarray) -> DeleteResult:
        """The delete's device work: tombstone every live row whose gid is
        in the sorted distinct ``want_host``.  Membership is a binary
        search of each stored gid in the upload, so the work and the host
        syncs (the upload and one fetch of the counts) do not depend on
        how many rows match."""
        st = self.store
        S = self.cfg.n_shards
        n_want = len(want_host)
        want = torch.as_tensor(want_host, device=self.device)
        pos = torch.searchsorted(want, st.gid).clamp_(max=max(n_want - 1, 0))
        hit = st.valid & (want[pos] == st.gid) if n_want else \
            torch.zeros_like(st.valid)
        # per requested gid: did any shard hold a live row of it?
        seen = torch.zeros((n_want + 1,), dtype=torch.bool,
                           device=self.device)
        at = torch.where(hit, pos, n_want).reshape(-1)
        seen.scatter_(0, at, torch.ones_like(at, dtype=torch.bool))
        counts = torch.stack([hit.sum(), hit[:, :st.n_sorted].sum(),
                              seen[:n_want].sum()])
        st.valid.logical_and_(~hit)
        # host-sync: delete-counts
        counts = torch.cat([st.valid.sum(dim=-1), counts]).cpu().numpy()
        load = counts[:S].astype(np.int64)
        n_deleted, n_sorted_hits, n_points = (int(v) for v in counts[S:])
        self._shard_load = load
        self._n_live -= n_deleted
        self._sorted_live -= n_sorted_hits
        self._tail_live -= n_deleted - n_sorted_hits
        return DeleteResult(n_deleted=n_deleted, n_points=n_points,
                            shard_load=load)

    # ------------------------------------------------------------------
    # Build: fresh store + one bulk insert
    # ------------------------------------------------------------------
    def build(self, data, capacity: Optional[int] = None) -> BuildResult:
        """(Re)build from scratch: reset the store and insert ``data``.
        ``capacity`` optionally pre-reserves per-shard ROWS."""
        n = data.shape[0]
        self._next_gid = 0
        self.init_store(max(capacity or 0,
                            self._store_capacity(n * self.cfg.n_tables)))
        self.insert(data)
        return self.build_result

    @property
    def build_result(self) -> Optional[BuildResult]:
        if self.store is None:
            return None
        st = self.store
        return BuildResult(
            store_x=st.x, store_packed=st.packed, store_gid=st.gid,
            store_table=st.table, store_key=st.key, store_valid=st.valid,
            data_load=self._shard_load, drops=self._drops)

    @property
    def n_live(self) -> int:
        return self._n_live

    @property
    def shard_load(self) -> np.ndarray:
        return np.asarray(self._shard_load)

    # ------------------------------------------------------------------
    # Live-rows-only serialise / re-route (compact and the LSM merge)
    # ------------------------------------------------------------------
    def host_live_rows(self) -> dict:
        """The LIVE rows of the store as flat host numpy arrays: x,
        packed (uint32), gid, table, key."""
        cfg = self.cfg
        if self.store is None:
            return {"x": np.zeros((0, cfg.d), np.float32),
                    "packed": np.zeros((0, 2), np.uint32),
                    "gid": np.zeros((0,), np.int32),
                    "table": np.zeros((0,), np.int32),
                    "key": np.zeros((0,), np.int32)}
        st = self.store
        sel = st.valid.reshape(-1)

        def flat(a):
            return a.reshape((-1,) + tuple(a.shape[2:]))[sel].cpu().numpy()
        return {"x": flat(st.x), "packed": flat(st.packed).view(np.uint32),
                "gid": flat(st.gid), "table": flat(st.table),
                "key": flat(st.key)}

    def load_rows(self, rows: dict, capacity: Optional[int] = None
                  ) -> np.ndarray:
        """Install host rows into freshly re-routed, BUCKET-SORTED regions
        (destination ``Key mod S``; one host lexsort by (dest, table, hi,
        lo) groups rows by shard in CSR order).  Returns per-shard loads.
        """
        cfg = self.cfg
        S, d = cfg.n_shards, cfg.d
        key = np.asarray(rows["key"], np.int64)
        table = np.asarray(rows["table"], np.int64)
        packed = np.asarray(rows["packed"], np.uint32).reshape(-1, 2)
        n = int(key.shape[0])
        dest = np.mod(key, S)
        counts = np.bincount(dest, minlength=S).astype(np.int64)
        cap_sorted = int(counts.max(initial=0))
        cap = max(8, cap_sorted + 8, self._store_capacity(n),
                  int(capacity or 0))
        order = np.lexsort((packed[:, 1], packed[:, 0], table, dest))
        sdest = dest[order]
        slot = (np.arange(n) - np.searchsorted(sdest, sdest)).astype(
            np.int64)

        def place(vals, shape, dtype, fill):
            buf = np.full((S, cap) + shape, fill, dtype)
            buf[sdest, slot] = np.asarray(vals, dtype)[order]
            return buf
        hx = place(rows["x"], (d,), np.float32, 0.0)
        hp = place(rows["packed"], (2,), np.uint32,
                   store_layout.SENTINEL_PACKED)
        hg = place(rows["gid"], (), np.int32, IMAX)
        ht = place(rows["table"], (), np.int32, IMAX)
        hk = place(rows["key"], (), np.int32, 0)
        hv = np.zeros((S, cap), bool)
        hv[sdest, slot] = True
        # sentinel rows live only inside the sorted region
        hp[:, cap_sorted:] = 0
        ht[:, cap_sorted:] = 0

        hbs = np.zeros((S, cap), np.int32)
        hbe = np.zeros((S, cap), np.int32)
        max_b, sum_b = 0, 0
        for s in range(S):
            c = int(counts[s])
            if c == 0:
                continue
            bs, be = store_layout.bucket_spans(ht[s, :c], hp[s, :c])
            hbs[s, :c], hbe[s, :c] = bs, be
            mx, mn = store_layout.bucket_stats(bs, be, c)
            max_b = max(max_b, mx)
            sum_b += int(round(mn * c))
        self._max_bucket = max_b
        self._mean_bucket = sum_b / n if n else 0.0

        put = lambda a: torch.as_tensor(a, device=self.device)
        x = put(hx)
        psq = torch.zeros((S, cap), dtype=torch.float32, device=self.device)
        for s in range(S):
            c = int(counts[s])
            psq[s, :c] = sq_norms(x[s, :c])
        self.store = StoreState.from_columns(dict(
            x=x, packed=put(hp.view(np.int32)), gid=put(hg), table=put(ht),
            key=put(hk), valid=put(hv), bucket_start=put(hbs),
            bucket_end=put(hbe), psq=psq), n_sorted=cap_sorted)
        self._shard_load = counts
        self._n_live = n
        self._used = cap_sorted
        self._sorted_live = n
        self._tail_live = 0
        return counts

    def compact(self) -> CompactResult:
        """Rewrite the regions live-rows-only and fully sorted (rows keep
        their shard, so loads and answers are unchanged)."""
        if self.store is None:
            raise RuntimeError("insert() or build() first")
        before = self.store.capacity
        load = self.load_rows(self.host_live_rows())
        self._merges += 1
        return CompactResult(capacity_before=before,
                             capacity_after=self.store.capacity,
                             n_live=self._n_live, shard_load=load)

    def merge_tail(self) -> CompactResult:
        """The LSM merge step: identical to ``compact()``, named for the
        auto-merge call site."""
        return self.compact()

    @property
    def layout(self) -> dict:
        st = self.store
        return {
            "n_sorted": 0 if st is None else st.n_sorted,
            "sorted_rows": self._sorted_live,
            "tail_rows": self._tail_live,
            "merges": self._merges,
            "max_bucket": self._max_bucket,
            "mean_bucket": self._mean_bucket,
        }

    # ------------------------------------------------------------------
    # Query: dispatch / scan / return, as the reference's three stage
    # bodies, every shard at once
    # ------------------------------------------------------------------
    def _keys_of(self, offs, table=None):
        """Offsets (T, N, d) under the stacked params, table t for row t,
        or (S, R, L, d) with ``table`` (S, R) per routed row -> (Key
        (..., L), packed H (..., L, 2))."""
        sp = self.stacked_params
        hk = hash_h(sp, offs, self.cfg.W, table)
        return (shard_key(sp, self.cfg, hk, table),
                pack_buckets(sp, hk, table))

    def _dispatch(self, q: torch.Tensor, m: int, Cq: int):
        """Stage 1: hash every local query's T x L offsets and route one
        row per distinct Key per table through ONE exchange."""
        cfg = self.cfg
        S, L, T, d = cfg.n_shards, cfg.L, cfg.n_tables, cfg.d
        m_loc = m // S
        dev = self.device
        q_loc = q.reshape(S, m_loc, d)
        qid = torch.arange(m, dtype=torch.int64, device=dev).reshape(
            S, m_loc)
        # (T, S, m_loc, L, d) offsets; table t from its own base key
        offs = query_offsets(self.stacked_keys[:, None, None, :],
                             qid.unsqueeze(0), q_loc.unsqueeze(0), L, cfg.r)
        keyv, packed = self._keys_of(offs.reshape(T, S * m_loc * L, d))
        keyv = keyv.reshape(T, S, m_loc, L).permute(1, 2, 0, 3)
        packed = packed.reshape(T, S, m_loc, L, 2).permute(1, 2, 0, 3, 4)
        if cfg.scheme == Scheme.SIMPLE:
            eq = (packed[..., :, None, :] == packed[..., None, :, :]).all(-1)
        else:
            eq = keyv[..., :, None] == keyv[..., None, :]
        ar = torch.arange(L, device=dev)
        earlier = ar[:, None] > ar[None, :]
        live = ~(eq & earlier).any(dim=-1)             # (S, m_loc, T, L)
        nr = m_loc * T * L
        dest = torch.remainder(keyv, S).reshape(S, nr)
        rows_q = q_loc.repeat_interleave(T * L, dim=1)
        rows_id = qid.to(torch.int32).repeat_interleave(T * L, dim=1)
        rows_t = torch.arange(T, dtype=torch.int32, device=dev
                              ).repeat_interleave(L).repeat(m_loc
                                                            ).expand(S, nr)
        slot, keep, drops = dispatch_slots(dest, live.reshape(S, nr), S, Cq)
        fq_local = keep.reshape(S, m_loc, T * L).sum(dim=-1)
        payload = torch.cat([_f2i(rows_q), rows_id[..., None],
                             rows_t[..., None]], dim=-1)
        r = self.a2a(scatter_rows(slot, keep, payload, S * Cq, IMAX))
        return r, fq_local, drops

    def _scan(self, r: torch.Tensor, m: int, K: int):
        """Stage 2: receive-side hash-once + bucket search + per-qid union
        across tables.  No exchange."""
        cfg = self.cfg
        S, L, T, d = cfg.n_shards, cfg.L, cfg.n_tables, cfg.d
        dev = self.device
        st = self.store
        rq = _i2f(r[..., :d])                          # (S, R, d)
        rid = r[..., d]
        rtab = r[..., d + 1]
        rvalid = rid != IMAX
        recv_load = rvalid.sum(dim=-1)
        # two rows of one (query, table) can land on one shard when their
        # Keys collide mod S; each row probes every bucket its table owns
        # here, so keep the first
        rvalid = first_occurrence_mask(
            torch.where(rvalid, rid * T + rtab, IMAX), rvalid)
        # The routed buffer is mostly padding (a bucket fills a few dozen
        # of its S * Cq slots per shard): regenerate offsets and scan only
        # the live rows, moved to the front in their order.  Their count
        # is read back once (a host sync) to size the work.
        # host-sync: scan-live-rows
        n_rows = max(1, int(rvalid.sum(dim=-1).max()))
        live = torch.argsort(rvalid.to(torch.int8), dim=-1, descending=True,
                             stable=True)[:, :n_rows]
        rq = torch.gather(rq, 1, live[..., None].expand(-1, -1, d))
        rid, rtab, rvalid = (torch.gather(a, 1, live)
                             for a in (rid, rtab, rvalid))
        rid_safe = torch.where(rvalid, rid, 0)
        rtab_safe = torch.where(rvalid, rtab, 0)

        roffs = query_offsets_by_table(self.stacked_keys, rtab_safe,
                                       rid_safe, rq, L, cfg.r)  # (S,R,L,d)
        rkey, rpacked = self._keys_of(roffs, rtab_safe)
        me = torch.arange(S, device=dev)[:, None, None]
        mine = (torch.remainder(rkey, S) == me) & rvalid[..., None]
        eqp = (rpacked[..., :, None, :] == rpacked[..., None, :, :]).all(-1)
        ar = torch.arange(L, device=dev)
        firstocc = ~(eqp & (ar[:, None] > ar[None, :])).any(dim=-1)
        probe = mine & firstocc                        # (S, R, L)

        R = rq.shape[1]
        qbatch = QueryBatch(q=rq, qsq=sq_norms(rq),
                            buckets=rpacked.reshape(S, R, 2 * L),
                            probe=probe.to(torch.int32), table=rtab_safe)
        # slots past the high-water mark were never written: leave them out
        used = lambda a: a[:, :max(self._used, st.n_sorted)]
        sview = StoreView(points=used(st.x), psq=used(st.psq),
                          buckets=used(st.packed), gid=used(st.gid),
                          valid=used(st.valid.to(torch.int32)),
                          table=used(st.table),
                          bucket_start=used(st.bucket_start),
                          bucket_end=used(st.bucket_end),
                          n_sorted=st.n_sorted)
        row_d, row_g, row_emit = kops.bucket_search(
            query=qbatch, store=sview,
            cr2=float(np.float32((cfg.c * cfg.r) ** 2)), L=L, k=K,
            force_full_scan=not self.use_csr)

        # ---- local union across tables: one live row per (qid, table)
        # on this shard; scatter per-row top-Ks into (qid, table) slots
        # and merge the T tables (dedup by gid) ----
        idx = torch.where(rvalid, rid * T + rtab, m * T).to(torch.int64)
        loc_d = torch.full((S, m * T + 1, K), INF, device=dev)
        loc_g = torch.full((S, m * T + 1, K), IMAX, dtype=torch.int32,
                           device=dev)
        loc_d.scatter_(1, idx[..., None].expand(-1, -1, K),
                       torch.where(rvalid[..., None], row_d, INF))
        loc_g.scatter_(1, idx[..., None].expand(-1, -1, K),
                       torch.where(rvalid[..., None], row_g, IMAX))
        loc_d, loc_g = merge_topk(loc_d[:, :m * T].reshape(S, m, T * K),
                                  loc_g[:, :m * T].reshape(S, m, T * K), K)
        emit = torch.zeros((S, m + 1), dtype=torch.int32, device=dev)
        emit.scatter_add_(1, torch.where(rvalid, rid, m).to(torch.int64),
                          torch.where(rvalid, row_emit, 0))
        ret = torch.cat([_f2i(loc_d), loc_g, emit[:, :m, None]], dim=-1)
        return ret, recv_load

    def _return(self, ret: torch.Tensor, m: int, K: int):
        """Stage 3: ONE routed exchange ships each qid's local top-K (+
        emit count) to its owner shard, which merges the S lists."""
        S = self.cfg.n_shards
        m_loc = m // S
        recv = self.a2a(ret).reshape(S, S, m_loc, 2 * K + 1)
        cand_d = _i2f(recv[..., :K]).permute(0, 2, 1, 3).reshape(
            S, m_loc, S * K)
        cand_g = recv[..., K:2 * K].permute(0, 2, 1, 3).reshape(
            S, m_loc, S * K)
        gtopd, gtopg = merge_topk(cand_d, cand_g, K)
        gemit = recv[..., 2 * K].sum(dim=1, dtype=torch.int32)
        return gtopd.reshape(m, K), gtopg.reshape(m, K), gemit.reshape(m)

    def _check_query_batch(self, queries, k_neighbors: Optional[int]):
        """The batch on the index's device, its size and its K."""
        if self.store is None:
            raise RuntimeError("call build() or insert() first")
        S = self.cfg.n_shards
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.device)
        m = q.shape[0]
        if m % S:
            raise ValueError(f"m={m} must divide by n_shards={S}")
        return q, m, self._check_k(k_neighbors)

    def _check_k(self, k_neighbors: Optional[int]) -> int:
        K = self.k_neighbors if k_neighbors is None else k_neighbors
        if not 1 <= K <= 128:
            raise ValueError(f"k_neighbors={K} not in [1, 128]")
        return K

    def query(self, queries, k_neighbors: Optional[int] = None
              ) -> QueryResult:
        """Answer a batch of queries (m, d), m divisible by n_shards."""
        q, m, K = self._check_query_batch(queries, k_neighbors)
        r, fq, drops = self._dispatch(
            q, m, self._query_capacity(m // self.cfg.n_shards))
        ret, recv_load = self._scan(r, m, K)
        gtopd, gtopg, gemit = self._return(ret, m, K)
        return _host_query_result(gtopd, gtopg, gemit, fq, recv_load, drops)

    # ------------------------------------------------------------------
    # Staged query: the same three stages, separately invocable.  Each
    # returns device tensors; the answers reach the host only when the
    # caller fetches them (``query_staged``, or a pipeline's retire).
    # ------------------------------------------------------------------
    def query_dispatch(self, queries) -> DispatchedBatch:
        """Stage 1/3: hash + route the batch through the dispatch
        exchange (one)."""
        q, m, _ = self._check_query_batch(queries, None)
        Cq = self._query_capacity(m // self.cfg.n_shards)
        recv, fq, drops = self._dispatch(q, m, Cq)
        return DispatchedBatch(recv=recv, fq=fq, drops=drops, m=m, Cq=Cq)

    def query_scan(self, disp: DispatchedBatch,
                   k_neighbors: Optional[int] = None) -> ScannedBatch:
        """Stage 2/3: per-shard bucket search over the routed payload; no
        exchange."""
        if self.store is None:
            raise RuntimeError("call build() or insert() first")
        K = self._check_k(k_neighbors)
        ret, recv_load = self._scan(disp.recv, disp.m, K)
        return ScannedBatch(ret=ret, recv_load=recv_load, m=disp.m, K=K)

    def query_return(self, scanned: ScannedBatch):
        """Stage 3/3: routed return exchange (one) + owner-shard K-way
        merge.  Returns device (topk_dist^2, topk_gid, n_within_cr)."""
        return self._return(scanned.ret, scanned.m, scanned.K)

    def query_staged(self, queries, k_neighbors: Optional[int] = None
                     ) -> QueryResult:
        """The three stages back to back, fetched: bitwise ``query()``."""
        disp = self.query_dispatch(queries)
        scanned = self.query_scan(disp, k_neighbors=k_neighbors)
        gtopd, gtopg, gemit = self.query_return(scanned)
        return _host_query_result(gtopd, gtopg, gemit, disp.fq,
                                  scanned.recv_load, disp.drops)
