"""Batched serving front-end for the port's streaming distributed LSH index.

``ShardedLSHService`` turns the sharded index into a query service:

  * micro-batching -- incoming queries accumulate into a fixed-size
    bucket (padded to the bucket, so every flush has one shape) and flush
    when the bucket fills, when a max-latency deadline expires, or on
    explicit ``flush()``/``drain()``;
  * streaming writes -- ``insert``/``delete`` route straight through the
    index's exchange append / tombstone path with capacity accounting;
  * durability -- with a ``repro_torch.persist.WriteAheadLog`` attached,
    every insert/delete batch is appended to the log (gids + raw points)
    BEFORE it is applied, so a crash at any point is recoverable by
    ``persist.recover`` (snapshot + idempotent WAL-tail replay);
  * accounting -- per-flush latency, occupancy, routed rows and overflow
    drops accumulate into ``ServiceStats``.  WAL-replayed writes go
    through the same ``insert``/``delete`` entry points, so they are
    counted too.

The front-end is synchronous and deterministic (no threads): deadlines
are checked on entry to ``submit``/``submit_batch``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

import torch

from repro_torch.core.index import (DeleteResult, DistributedLSHIndex,
                                    InsertResult, check_gid_range)
from repro_torch.runtime import spans


@dataclasses.dataclass
class PendingQuery:
    """Handle for one submitted query; resolved when its bucket flushes."""
    _service: "ShardedLSHService"
    done: bool = False
    gid: int = -1                 # global id of best (c,r)-NN (IMAX if none)
    dist: float = float("inf")   # distance of best candidate
    gids: Optional[np.ndarray] = None    # (K,) top-K gids (IMAX-padded)
    dists: Optional[np.ndarray] = None   # (K,) ascending dists (inf-padded)
    n_within_cr: int = 0          # candidates within cr across all shards
    fq: int = 0                   # routed rows (Definition 7)
    t_submit: float = 0.0         # service clock at admission (for latency)

    def result(self) -> "PendingQuery":
        """Block until resolved (forces a flush of the owning bucket)."""
        while not self.done:
            self._service.flush(reason="manual")
        return self


@dataclasses.dataclass
class ServiceStats:
    queries: int = 0              # queries answered
    batches: int = 0              # buckets flushed
    flush_full: int = 0           # flushes triggered by a full bucket
    flush_deadline: int = 0       # flushes triggered by the latency SLO
    flush_manual: int = 0         # explicit flush()/drain()/result()
    pad_rows: int = 0             # padding rows shipped (bucket - live)
    inserts: int = 0              # points inserted
    insert_rows: int = 0          # routed rows stored (points x n_tables)
    insert_batches: int = 0
    deletes: int = 0              # points deleted (distinct gids hit --
    #                               mirrors ``inserts``)
    delete_rows: int = 0          # rows tombstoned (points x n_tables --
    #                               mirrors ``insert_rows``)
    delete_batches: int = 0
    drops: int = 0                # capacity overflow anywhere (must stay 0)
    routed_rows: int = 0          # live query rows shipped (network cost,
    #                               summed over the fused tables)
    query_time_s: float = 0.0     # wall time inside flushed query steps
    insert_time_s: float = 0.0
    # store-layout health (mirrored from the index after every write):
    # a growing tail erodes the CSR win -- each query full-scans it --
    # until the next merge folds it back into the sorted region
    store_sorted_rows: int = 0    # live rows in the bucket-sorted region
    store_tail_rows: int = 0      # live rows in the unsorted insert tail
    store_merges: int = 0         # LSM tail merges (incl. compactions)
    # async front-end accounting (zero when serving synchronously)
    queue_peak: int = 0           # deepest the admission queue has been
    inflight_peak: int = 0        # most pipelined batches in flight at once
    rejects: int = 0              # admissions refused (admission="reject")
    snapshots: int = 0            # background snapshots written
    snapshots_skipped: int = 0    # snapshot requests skipped (one in flight)
    # per-query latency reservoir (submit -> resolve, ms).  Bounded: keeps
    # the most recent _LAT_CAP samples so a long-lived service doesn't
    # grow without bound; percentiles reflect recent traffic.
    _lat_ms: list = dataclasses.field(default_factory=list, repr=False)

    _LAT_CAP = 8192

    def record_latency(self, ms: float) -> None:
        self._lat_ms.append(ms)
        if len(self._lat_ms) > 2 * self._LAT_CAP:
            del self._lat_ms[:-self._LAT_CAP]

    @property
    def latency_p50_ms(self) -> float:
        lat = self._lat_ms[-self._LAT_CAP:]
        return float(np.percentile(lat, 50)) if lat else 0.0

    @property
    def latency_p99_ms(self) -> float:
        lat = self._lat_ms[-self._LAT_CAP:]
        return float(np.percentile(lat, 99)) if lat else 0.0

    @property
    def collectives_issued(self) -> int:
        """Cross-shard collectives the fused index issued for this stream:
        2 per query flush (dispatch + routed return) and 1 per insert
        batch, INDEPENDENT of n_tables (a naive T-table deployment pays
        T x this)."""
        return 2 * self.batches + self.insert_batches

    @property
    def occupancy(self) -> float:
        """Live fraction of shipped query rows (1.0 = no padding waste)."""
        total = self.queries + self.pad_rows
        return self.queries / total if total else 0.0

    @property
    def queries_per_s(self) -> float:
        return self.queries / self.query_time_s if self.query_time_s else 0.0

    @property
    def inserts_per_s(self) -> float:
        return self.inserts / self.insert_time_s if self.insert_time_s \
            else 0.0

    def summary(self) -> str:
        return (f"queries={self.queries} batches={self.batches} "
                f"(full={self.flush_full} deadline={self.flush_deadline} "
                f"manual={self.flush_manual}) occupancy={self.occupancy:.2f} "
                f"qps={self.queries_per_s:.0f} "
                f"inserts={self.inserts} ips={self.inserts_per_s:.0f} "
                f"deletes={self.deletes} "
                f"(rows={self.delete_rows}) "
                f"rows/query="
                f"{self.routed_rows / max(self.queries, 1):.2f} "
                f"collectives={self.collectives_issued} "
                f"store=sorted:{self.store_sorted_rows}"
                f"+tail:{self.store_tail_rows} "
                f"merges={self.store_merges} "
                f"lat(p50/p99)={self.latency_p50_ms:.1f}/"
                f"{self.latency_p99_ms:.1f}ms "
                + (f"queue_peak={self.queue_peak} "
                   f"inflight_peak={self.inflight_peak} "
                   f"rejects={self.rejects} "
                   f"snapshots={self.snapshots}"
                   f"(+{self.snapshots_skipped} skipped) "
                   if self.inflight_peak or self.queue_peak else "")
                + f"drops={self.drops}")


class ShardedLSHService:
    """Micro-batching query/insert front-end over a DistributedLSHIndex."""

    def __init__(self, index: DistributedLSHIndex, bucket_size: int = 64,
                 max_latency_ms: float = 25.0,
                 k_neighbors: Optional[int] = None, wal=None,
                 clock=time.monotonic,
                 stats: Optional[ServiceStats] = None):
        """k_neighbors: top-K returned per query (defaults to the index's
        own k_neighbors).

        wal: optional ``repro_torch.persist.WriteAheadLog``.  When
        attached, every insert/delete batch is appended (gids + raw
        float32 points) BEFORE it is applied to the index -- the
        durability contract is "appended == will survive a crash"
        (``persist.recover`` replays the tail idempotently on top of the
        latest snapshot).  A batch the index would refuse never reaches
        the log.

        clock: monotonic-seconds callable used for deadlines, latency
        and timing stats (injectable so SLO tests advance time without
        sleeping).

        stats: share an existing ServiceStats (the async front-end embeds
        this service for its write path and keeps ONE accounting view)."""
        S = index.cfg.n_shards
        if bucket_size % S:
            raise ValueError(
                f"bucket_size={bucket_size} must divide by n_shards={S}")
        self.index = index
        self.bucket_size = bucket_size
        self.max_latency_ms = max_latency_ms
        self.k_neighbors = (index.k_neighbors if k_neighbors is None
                            else k_neighbors)
        if not 1 <= self.k_neighbors <= 128:
            raise ValueError(
                f"k_neighbors={self.k_neighbors} not in [1, 128]")
        self.stats = ServiceStats() if stats is None else stats
        self._clock = clock
        self._pending: List[PendingQuery] = []
        self._pending_q: List[np.ndarray] = []
        self._deadline: Optional[float] = None
        self.wal = wal
        self._replaying = False   # persist.recover: apply without re-append

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------
    def submit(self, q) -> PendingQuery:
        """Enqueue one (d,) query; flushes full buckets / missed deadlines."""
        return self.submit_batch(np.asarray(q, np.float32)[None])[0]

    def submit_batch(self, qs) -> List[PendingQuery]:
        """Enqueue (b, d) queries, preserving submission order."""
        qs = np.asarray(qs, np.float32)
        if qs.ndim != 2 or qs.shape[1] != self.index.cfg.d:
            raise ValueError(f"queries must be (b, {self.index.cfg.d}), "
                             f"got {qs.shape}")
        self._check_deadline()
        handles = []
        for row in qs:
            h = PendingQuery(_service=self)
            self._pending.append(h)
            self._pending_q.append(row)
            handles.append(h)
            h.t_submit = self._clock()
            if self._deadline is None:
                self._deadline = h.t_submit + self.max_latency_ms / 1e3
            if len(self._pending) >= self.bucket_size:
                self.flush(reason="full")
        return handles

    def _check_deadline(self) -> None:
        if (self._pending and self._deadline is not None
                and self._clock() >= self._deadline):
            self.flush(reason="deadline")

    def flush(self, reason: str = "manual") -> int:
        """Answer up to one bucket of pending queries; returns the count."""
        if reason not in ("full", "deadline", "manual"):
            raise ValueError(f"unknown flush reason {reason!r}")
        if not self._pending:
            self._deadline = None
            return 0
        take = min(len(self._pending), self.bucket_size)
        handles = self._pending[:take]
        rows = self._pending_q[:take]
        del self._pending[:take], self._pending_q[:take]
        # the deadline of the queries being flushed -- restored verbatim
        # if the query step fails and they are requeued below, so a
        # requeued query keeps its original SLO instead of losing the
        # deadline until a fresh submit arrives
        prev_deadline = self._deadline
        self._deadline = (self._clock() + self.max_latency_ms / 1e3
                          if self._pending else None)

        with spans.span("serve.flush"):
            pad = self.bucket_size - take
            buf = np.zeros((self.bucket_size, self.index.cfg.d), np.float32)
            buf[:take] = rows
            t0 = self._clock()
            try:
                res = self.index.query(buf, k_neighbors=self.k_neighbors)
            except BaseException:
                # a failed query step must not orphan the handles (result()
                # would spin forever on an empty queue): requeue with their
                # ORIGINAL deadline (already advanced/cleared above) and
                # surface the error
                self._pending[:0] = handles
                self._pending_q[:0] = rows
                self._deadline = prev_deadline
                raise
            now = self._clock()
            dt = now - t0

            st = self.stats
            for i, h in enumerate(handles):
                h.gids = res.topk_gid[i].copy()
                h.dists = res.topk_dist[i].copy()
                h.gid = int(h.gids[0])
                h.dist = float(h.dists[0])
                h.n_within_cr = int(res.n_within_cr[i])
                h.fq = int(res.fq[i])
                h.done = True
                st.record_latency((now - h.t_submit) * 1e3)

            st.queries += take
            st.batches += 1
            st.pad_rows += pad
            st.drops += res.drops
            # padded rows still route (their offsets are hashed), so count
            # only the live rows as the paper's shuffle size
            st.routed_rows += int(res.fq[:take].sum())
            st.query_time_s += dt
            setattr(st, f"flush_{reason}", getattr(st, f"flush_{reason}") + 1)
            return take

    def drain(self) -> int:
        """Flush until no queries are pending; returns the total answered."""
        total = 0
        while self._pending:
            total += self.flush(reason="manual")
        return total

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------------------
    # Streaming writes
    # ------------------------------------------------------------------
    def insert(self, points, gids=None) -> InsertResult:
        """Route a batch of new points into the sharded store.

        With a WAL attached the batch (explicit gids + raw points) is
        appended to the log BEFORE it is applied; auto-assigned gids are
        materialised from the index's allocator first so the logged batch
        replays bit-identically.
        """
        self._check_deadline()   # writes must not starve pending queries
        if self.wal is not None and not self._replaying:
            # the raw points go into the log: fetch them to the host
            if isinstance(points, torch.Tensor):
                points = points.detach().cpu().numpy()
            points = np.asarray(points, np.float32)
            if gids is None:
                n = points.shape[0]
                gids = np.arange(self.index._next_gid,
                                 self.index._next_gid + n, dtype=np.int64)
            gids = np.asarray(gids, np.int64)
            # validate BEFORE appending: a batch the index would reject
            # must never reach the log, or every future recover() replays
            # it into the same exception and the service can't boot
            if points.ndim != 2 or points.shape[1] != self.index.cfg.d:
                raise ValueError(f"points must be (n, {self.index.cfg.d}), "
                                 f"got {points.shape}")
            if gids.shape[0] != points.shape[0]:
                raise ValueError(f"gids ({gids.shape[0]}) / points "
                                 f"({points.shape[0]}) length mismatch")
            check_gid_range(gids)
            self.wal.append_insert(gids, points)
        t0 = self._clock()
        res = self.index.insert(points, gids=gids)
        self.stats.insert_time_s += self._clock() - t0
        self.stats.inserts += res.n_inserted
        self.stats.insert_rows += res.rows_stored
        self.stats.insert_batches += 1
        self.stats.drops += res.drops
        self._sync_layout_stats()
        return res

    def delete(self, gids) -> DeleteResult:
        """Tombstone rows by global id (WAL-appended first, like insert)."""
        self._check_deadline()
        gids = np.asarray(gids, np.int64).reshape(-1)
        if self.wal is not None and not self._replaying:
            check_gid_range(gids)   # never log a batch the index rejects
            self.wal.append_delete(gids)
        res = self.index.delete(gids)
        self.stats.deletes += res.n_points
        self.stats.delete_rows += res.n_deleted
        self.stats.delete_batches += 1
        self._sync_layout_stats()
        return res

    def _sync_layout_stats(self) -> None:
        layout = self.index.layout
        self.stats.store_sorted_rows = layout["sorted_rows"]
        self.stats.store_tail_rows = layout["tail_rows"]
        self.stats.store_merges = layout["merges"]

    # ------------------------------------------------------------------
    def shard_load(self) -> np.ndarray:
        """Live stored rows per shard (the paper's load-balance metric)."""
        return self.index.shard_load
