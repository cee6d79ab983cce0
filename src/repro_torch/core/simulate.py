"""Analytic cluster simulator: exact traffic / load-balance / recall numbers
for any shard count without building the sharded index.

This computes the quantities the distributed index produces (held equal
to it in tests), vectorised over the whole dataset, so the paper's
1024-reducer Table 1 and the Fig 4.1 shuffle-size curves run on one
device.

Multi-table (``cfg.n_tables`` = T > 1) accounting mirrors the fused index:
each table hashes with its own split-key parameters, rows/loads sum over
tables (with a per-table breakdown in the report), and recall is computed
on the UNION candidate set -- a point is a candidate iff ANY table
co-buckets it with any probed offset of that table.

Every H and G goes through ``core/hashing.py``, so on the card through
the hash kernel; the rest is plain tensor code.  Queries are hashed in
blocks (``OFFSET_DRAWS``): the PRNG holds its words in int64, and all of
a large query set's offsets at once would take tens of GB of
temporaries.  Query ids are global, so a block draws the same offsets as
the whole set.  Inputs may be numpy arrays or tensors; ``device=None``
is the card.  Parameters and offset keys are ``make_sim(cfg)``'s, the
index's own derivation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import accounting, prng
from repro_torch.core.config import LSHConfig, Scheme
from repro_torch.core.hashing import (HashParams, StackedHashParams, hash_h,
                                      pack_buckets, sample_stacked_params,
                                      shard_key, shard_of)
from repro_torch.core.index import resolve_device
from repro_torch.core.multiprobe import batch_mplsh_probes, probe_valid_mask
from repro_torch.core.offsets import batch_query_offsets, stacked_base_keys
from repro_torch.core.ref_search import (as_f32, nearest_neighbors,
                                         pad_key, sq_dists)
from repro_torch.kernels.ref import lex_key, lex_unkey, merge_lex_topk

# normal draws (L x d a query) one block of queries' offsets takes at once
OFFSET_DRAWS = 1 << 24
# (query, probe, point) comparisons one chunk of the candidate test makes
# at most: the data chunk shrinks below ``data_chunk`` for large m x L
CHUNK_PAIRS = 1 << 28


def _dedupe_mask_2d(vals: torch.Tensor) -> torch.Tensor:
    """(m, L) int32 -> bool mask marking the FIRST occurrence of each value
    within each row (the paper's 'for each unique value x in the set')."""
    dup = vals[:, :, None] == vals[:, None, :]             # (m, L, L)
    idx = torch.arange(vals.shape[1], device=vals.device)
    earlier = idx[None, :, None] > idx[None, None, :]      # j earlier than i
    return ~torch.any(dup & earlier, dim=-1)


def _dedupe_mask_packed(packed: torch.Tensor) -> torch.Tensor:
    """(m, L, 2) packed buckets (int32 bit patterns; equality is all that
    is asked of them) -> first-occurrence mask (m, L)."""
    eq = torch.all(packed[:, :, None, :] == packed[:, None, :, :], dim=-1)
    idx = torch.arange(packed.shape[1], device=packed.device)
    earlier = idx[None, :, None] > idx[None, None, :]
    return ~torch.any(eq & earlier, dim=-1)


@dataclasses.dataclass
class SimState:
    """Sampled scheme state, in the index's canonical stacked form."""
    cfg: LSHConfig
    stacked_params: StackedHashParams  # leading-T-axis params
    stacked_keys: torch.Tensor         # (T, 2) offset base keys

    def to(self, device) -> "SimState":
        return SimState(self.cfg, self.stacked_params.to(device),
                        self.stacked_keys.to(device))


def make_sim(cfg: LSHConfig, device=None) -> SimState:
    """The index's parameters and offset keys for ``cfg.seed``, sampled on
    the CPU (the same bits on every device) and placed on ``device`` (the
    card unless the caller names one)."""
    dev = resolve_device(device)
    kp, kq = prng.split(prng.PRNGKey(cfg.seed))
    return SimState(cfg, sample_stacked_params(kp, cfg),
                    stacked_base_keys(kq, cfg.n_tables)).to(dev)


def _setup(cfg, data, queries, device):
    dev = resolve_device(device)
    return make_sim(cfg, dev), as_f32(data, dev), as_f32(queries, dev)


def _data_shards(sim: SimState, data: torch.Tensor) -> np.ndarray:
    """(T, n) destination shard of every point under every table: one
    hash of the tables side by side (as the fused index's insert)."""
    hk = hash_h(sim.stacked_params, data, sim.cfg.W)       # (T, n, k)
    return shard_of(sim.stacked_params, sim.cfg, hk).cpu().numpy()


def _offset_hashes(params: HashParams, base_key: torch.Tensor,
                   qids: torch.Tensor, queries: torch.Tensor,
                   cfg: LSHConfig) -> torch.Tensor:
    """(m, L, k) buckets of every query's entropy offsets, drawn and
    hashed a block of queries at a time."""
    step = max(1, OFFSET_DRAWS // (cfg.L * queries.shape[1]))
    return torch.cat([
        hash_h(params, batch_query_offsets(base_key, qids[i:i + step],
                                           queries[i:i + step], cfg.L,
                                           cfg.r), cfg.W)
        for i in range(0, queries.shape[0], step)])


def _probe_hashes(sim: SimState, queries: torch.Tensor, qids: torch.Tensor,
                  table: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """First-layer bucket vectors of every probe of one table: (m, L', k)
    int32 plus a (m, L') validity mask (False on mplsh sentinel rows)."""
    cfg = sim.cfg
    params = sim.stacked_params.table(table)
    if cfg.probes == "mplsh":
        hk_off = batch_mplsh_probes(params, cfg, queries, cfg.L)
        return hk_off, probe_valid_mask(hk_off)
    hk_off = _offset_hashes(params, sim.stacked_keys[table], qids, queries,
                            cfg)
    return hk_off, torch.ones(hk_off.shape[:2], dtype=torch.bool,
                              device=hk_off.device)


def _live_routes(params: HashParams, cfg: LSHConfig, hk_off: torch.Tensor,
                 pvalid: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(live (m, L') bool, dest (m, L') shard) of one table's probes: one
    pair per distinct H-bucket for SIMPLE (its Key is the bucket id), one
    per distinct GH value otherwise."""
    keys_off = shard_key(params, cfg, hk_off)              # (m, L') int32
    if cfg.scheme == Scheme.SIMPLE:
        live = _dedupe_mask_packed(pack_buckets(params, hk_off))
    else:
        live = _dedupe_mask_2d(keys_off)
    if pvalid is not None:
        live = live & pvalid
    return live, torch.remainder(keys_off, cfg.n_shards).to(torch.int64)


def simulate(cfg: LSHConfig, data, queries, compute_recall: bool = False,
             data_chunk: int = 4096, k_neighbors: Optional[int] = None,
             device=None) -> accounting.TrafficReport:
    """Run the full accounting for one scheme on one dataset.

    Args:
      data: (n, d) float32 data points.
      queries: (m, d) float32 query points.
      compute_recall: if True, run the exact (chunked) candidate search and
        report the paper's recall metric (>=1 point within r returned).
        With n_tables > 1 the candidate set is the union over tables.
      k_neighbors: additionally report recall@K (fraction of the exact
        brute-force top-K retrieved by the LSH candidate top-K within cr)
        -- requires compute_recall=True.
    """
    sim, data, queries = _setup(cfg, data, queries, device)
    n, d = data.shape
    m = queries.shape[0]
    S, T = cfg.n_shards, cfg.n_tables
    qids = torch.arange(m, dtype=torch.int32, device=data.device)

    data_load = np.zeros((S,), np.int64)
    query_load = torch.zeros((S,), dtype=torch.int64, device=data.device)
    fq = torch.zeros((m,), dtype=torch.int64, device=data.device)
    q_rows_t, d_rows_t = [], []
    probes_t: list = []          # per-table (hk_off, pvalid) for recall

    # index build: one row per point per table, hashed in one stacked pass
    data_shard_T = _data_shards(sim, data)                 # (T, n)
    for t in range(T):
        params = sim.stacked_params.table(t)
        data_load += np.bincount(data_shard_T[t], minlength=S)
        d_rows_t.append(n)

        # ------------- query routing -----------------------------------
        hk_off, pvalid = _probe_hashes(sim, queries, qids, table=t)
        if compute_recall:
            probes_t.append((hk_off, pvalid))
        live, dest = _live_routes(params, cfg, hk_off, pvalid)
        query_load += torch.bincount(dest[live], minlength=S)
        fq += live.sum(dim=1)
        q_rows_t.append(int(live.sum()))

    fq = fq.cpu().numpy()
    query_load = query_load.cpu().numpy()
    query_rows = int(sum(q_rows_t))
    report = accounting.TrafficReport(
        scheme=cfg.scheme.value,
        n_shards=S,
        query_rows=query_rows,
        query_bytes=query_rows * accounting.query_row_bytes(d, T),
        fq_mean=float(fq.mean()),
        fq_max=int(fq.max()),
        fq_bound=cfg.fq_bound(),
        data_rows=n * T,
        data_bytes=n * T * accounting.data_row_bytes(d, T),
        data_load_avg=float(data_load.mean()),
        data_load_max=int(data_load.max()),
        query_load_avg=float(query_load.mean()),
        query_load_max=int(query_load.max()),
        n_tables=T,
        query_rows_by_table=tuple(q_rows_t),
        data_rows_by_table=tuple(d_rows_t),
    )

    if compute_recall:
        rec, emitted, _, lsh_idx = _exact_search_recall(
            cfg, sim.stacked_params.as_tables(), data, queries, probes_t,
            data_chunk, k=k_neighbors)
        report.recall = rec
        report.results_emitted = emitted
        if k_neighbors:
            _, true_idx = nearest_neighbors(data, queries, k_neighbors,
                                            device=data.device)
            report.recall_at_k = recall_at_k(lsh_idx, true_idx)
            report.k_neighbors = k_neighbors
    return report


def recall_at_k(retrieved: np.ndarray, truth: np.ndarray) -> float:
    """Mean per-query |retrieved top-K ∩ exact top-K| / K (the survey's
    recall@K).  Sentinel (IMAX) entries never match real indices."""
    m, k = truth.shape
    overlap = (retrieved[:, :, None] == truth[:, None, :]).any(axis=1)
    valid = truth != np.iinfo(np.int32).max
    return float((overlap & valid).sum(axis=1).mean() / k)


def lsh_topk_reference(cfg: LSHConfig, data, queries, k: int,
                       data_chunk: int = 4096, device=None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Single-machine LSH top-K ground truth: for each query, the exact K
    best (dist, gid) pairs among its LSH candidate set (points whose
    H-bucket matches a probed bucket in ANY of the n_tables tables)
    within distance cr, in (dist, gid) lex order -- what the sharded
    fused index must reproduce regardless of placement scheme or table
    count.

    Returns (m, k) sqrt-distances (inf pad) and gids (IMAX pad).
    """
    sim, data, queries = _setup(cfg, data, queries, device)
    qids = torch.arange(queries.shape[0], dtype=torch.int32,
                        device=data.device)
    probes_t = [_probe_hashes(sim, queries, qids, table=t)
                for t in range(cfg.n_tables)]
    _, _, topd, topg = _exact_search_recall(
        cfg, sim.stacked_params.as_tables(), data, queries, probes_t,
        data_chunk, k=k)
    return topd, topg


@dataclasses.dataclass
class StreamReport:
    """Steady-state accounting for a streaming insert+query mix.

    The paper's two figures of merit (shuffle size, max reducer load)
    measured in the serving regime: the index grows online while query
    buckets flush against the current store, so load balance and traffic
    are trajectories, not single numbers.  Rows sum over the fused
    tables.
    """
    scheme: str
    n_shards: int
    steps: int
    total_inserted: int
    total_queries: int
    # ---- traffic (per step: live routed rows) ----
    query_rows_per_step: np.ndarray    # (steps,)
    insert_rows_per_step: np.ndarray   # (steps,)
    fq_mean: float                     # rows/query over the whole stream
    # ---- load balance trajectories (max/avg skew per step) ----
    data_skew: np.ndarray              # (steps,) store skew after insert
    query_skew: np.ndarray             # (steps,) query-shard skew per step
    data_load_final: np.ndarray        # (S,) live rows at end of stream
    n_tables: int = 1

    @property
    def data_skew_final(self) -> float:
        avg = max(float(self.data_load_final.mean()), 1.0)
        return float(self.data_load_final.max()) / avg

    def summary(self) -> str:
        return (f"scheme={self.scheme} shards={self.n_shards} "
                f"tables={self.n_tables} "
                f"steps={self.steps} inserted={self.total_inserted} "
                f"queries={self.total_queries} "
                f"rows/query={self.fq_mean:.2f} "
                f"data skew final={self.data_skew_final:.2f} "
                f"(per-step max {self.data_skew.max():.2f}) "
                f"query skew mean={self.query_skew.mean():.2f}")


def simulate_stream(cfg: LSHConfig, data, queries, n_prefix: int,
                    insert_batch: int, query_batch: int,
                    device=None) -> StreamReport:
    """Analytic streaming mix: build on data[:n_prefix], then per step
    insert the next ``insert_batch`` rows and answer ``query_batch``
    queries (cycling through ``queries``) against the grown store.

    Query ids restart per bucket -- exactly what the serving front-end's
    pad-to-bucket flush does -- so per-step traffic matches the service.
    Inserted-row counts are POINTS (the fused index stores n_tables rows
    per point; loads below count rows, matching ``shard_load``).
    """
    sim, data, queries = _setup(cfg, data, queries, device)
    n = data.shape[0]
    m_all = queries.shape[0]
    S, T = cfg.n_shards, cfg.n_tables

    data_shard_t = _data_shards(sim, data)   # (T, n) shard ids
    load = np.zeros((S,), np.int64)
    for t in range(T):
        load += np.bincount(data_shard_t[t][:n_prefix], minlength=S)

    qids = torch.arange(query_batch, dtype=torch.int32, device=data.device)
    steps = max(1, (n - n_prefix) // max(insert_batch, 1))
    q_rows, i_rows, d_skew, q_skew = [], [], [], []
    total_q = 0
    fq_sum = 0.0
    for step in range(steps):
        lo = n_prefix + step * insert_batch
        hi = min(n, lo + insert_batch)
        for t in range(T):
            load += np.bincount(data_shard_t[t][lo:hi], minlength=S)
        i_rows.append(hi - lo)
        d_skew.append(load.max() / max(load.mean(), 1.0))

        sel = (np.arange(query_batch) + step * query_batch) % m_all
        q = queries[torch.from_numpy(sel).to(data.device)]
        step_rows = 0
        qload = torch.zeros((S,), dtype=torch.int64, device=data.device)
        for t in range(T):
            params = sim.stacked_params.table(t)
            hk_off = _offset_hashes(params, sim.stacked_keys[t], qids, q,
                                    cfg)
            live, dest = _live_routes(params, cfg, hk_off)
            qload += torch.bincount(dest[live], minlength=S)
            step_rows += int(live.sum())
        qload = qload.cpu().numpy()
        q_rows.append(step_rows)
        q_skew.append(qload.max() / max(qload.mean(), 1.0))
        fq_sum += float(step_rows)
        total_q += query_batch

    return StreamReport(
        scheme=cfg.scheme.value, n_shards=S, steps=steps,
        total_inserted=int(sum(i_rows)), total_queries=total_q,
        query_rows_per_step=np.asarray(q_rows),
        insert_rows_per_step=np.asarray(i_rows),
        fq_mean=fq_sum / max(total_q, 1),
        data_skew=np.asarray(d_skew), query_skew=np.asarray(q_skew),
        data_load_final=load, n_tables=T)


def _exact_search_recall(cfg: LSHConfig, tables: List[HashParams],
                         data: torch.Tensor, queries: torch.Tensor,
                         probes_t: list, data_chunk: int,
                         k: Optional[int] = None
                         ) -> tuple[float, int,
                                    Optional[np.ndarray],
                                    Optional[np.ndarray]]:
    """Chunked exact candidate search (single pass over the data).

    A data point p is a candidate for query q iff H_t(p) equals
    H_t(q+delta^t_i) for some table t and live offset i of that table
    (placement scheme does NOT change the candidate set -- GH is a
    function of H, so bucket-mates are always co-located with the routed
    query row).  ``probes_t`` is a list of per-table (hk_off, pvalid)
    pairs as produced by ``_probe_hashes``.  Returns
      (recall, emitted, topk_dist, topk_gid):
    recall = fraction of queries for which a returned candidate lies
    within distance r; emitted = total (candidate, table) hits within cr
    -- a point co-bucketed in several tables counts once per table,
    matching the distributed path's n_within_cr; with k set, also the
    per-query exact top-K among candidates within cr, as (m, k)
    sqrt-distances / gids in (dist, gid) lex order (else None, None).
    The data walk in chunks of at most ``data_chunk`` points, fewer
    where m x L would pass CHUNK_PAIRS comparisons a chunk; chunking does
    not change the answers.
    """
    T = len(probes_t)
    m, L = probes_t[0][0].shape[:2]
    dev = data.device
    packed_off_t = [pack_buckets(tables[t], probes_t[t][0])
                    for t in range(T)]                     # (m, L, 2) each
    r2 = torch.tensor(cfg.r ** 2, dtype=torch.float32, device=dev)
    cr2 = torch.tensor((cfg.c * cfg.r) ** 2, dtype=torch.float32,
                       device=dev)
    q_sq = torch.sum(queries ** 2, dim=-1)                 # (m,)
    pad = pad_key(dev)

    hits = torch.zeros((m,), dtype=torch.bool, device=dev)
    emitted = torch.zeros((), dtype=torch.int64, device=dev)
    best = pad.expand(m, k) if k else None
    n = data.shape[0]
    packed_data_t = [
        pack_buckets(tables[t], hash_h(tables[t], data, cfg.W))
        for t in range(T)]
    step = max(1, min(data_chunk, CHUNK_PAIRS // max(1, m * L)))
    for s in range(0, n, step):
        e = min(n, s + step)
        chunk = data[s:e]
        # (m, B) candidate mask per table; emit counts sum over tables
        cand_any = torch.zeros((m, e - s), dtype=torch.bool, device=dev)
        n_hit_tables = torch.zeros((m, e - s), dtype=torch.int32,
                                   device=dev)
        for t in range(T):
            eq = torch.all(packed_off_t[t][:, :, None, :]
                           == packed_data_t[t][None, None, s:e], dim=-1)
            cand_t = torch.any(eq & probes_t[t][1][:, :, None], dim=1)
            cand_any |= cand_t
            n_hit_tables += cand_t.to(torch.int32)
        d2 = sq_dists(queries, q_sq, chunk)
        within = d2 <= cr2
        hits |= torch.any(cand_any & (d2 <= r2), dim=1)
        emitted += torch.sum(torch.where(within, n_hit_tables, 0))
        if k:
            gid = torch.arange(s, e, dtype=torch.int32, device=dev)
            keys = torch.where(cand_any & within,
                               lex_key(d2, gid.expand_as(d2)), pad)
            best = merge_lex_topk(torch.cat([best, keys], dim=1), k)
    recall = int(hits.sum()) / m
    if not k:
        return recall, int(emitted), None, None
    d2, gid = lex_unkey(best)
    return recall, int(emitted), np.sqrt(d2.cpu().numpy()), gid.cpu().numpy()
