"""Async worker front-end: admission queue + engine thread + futures.

``AsyncLSHService`` wraps the staged query pipeline and the synchronous
write path behind a bounded admission queue (threads, not processes:
the index is one program over all its shards on one device).  One
ENGINE thread owns the index -- it makes every CUDA call that touches
the index's tensors, on the device it selects for itself -- admits work
in FIFO order, keeps up to ``pipeline_depth`` query micro-batches in flight
through the double-buffered ``QueryPipeline``, applies writes through an
embedded ``ShardedLSHService`` (same WAL append-before-apply contract),
and hands snapshot writes to a background ``persist.SnapshotWriter``
(the state fetch runs on the engine thread, only host copies reach the
writer thread) -- so ingest, query flushing and snapshotting never block
each other or the caller.

Determinism: all index work happens on the one engine thread in
admission order, so the answer stream is bitwise identical to driving a
synchronous ``ShardedLSHService`` with the same call sequence (the
pipeline only overlaps DEVICE work; it never reorders batches).  The
one scheduling difference is deadline flushes, which the engine checks
continuously rather than at the next submit -- tests pin this down with
an injectable clock and explicit flush points.

Backpressure: the admission queue is bounded by ``queue_depth``.
``admission="block"`` applies backpressure to producers (put blocks);
``admission="reject"`` raises ``AdmissionFull`` and counts the reject
in ``ServiceStats``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.index import DistributedLSHIndex
from repro_torch.serving.pipeline import QueryPipeline
from repro_torch.serving.service import ServiceStats, ShardedLSHService

# engine poll quantum (real seconds): bounds how stale an injected-clock
# deadline check can get while the engine is blocked on an empty queue
_POLL_S = 0.005


class AdmissionFull(RuntimeError):
    """Raised by admission="reject" when the bounded queue is full."""


class AsyncQuery:
    """Future-like handle for one query admitted to the async service.

    Exposes the same result surface as ``PendingQuery`` (gids / dists /
    gid / dist / n_within_cr / fq / done) once resolved.
    """

    __slots__ = ("_service", "_event", "_error", "done", "gid", "dist",
                 "gids", "dists", "n_within_cr", "fq", "t_submit")

    def __init__(self, service: "AsyncLSHService", t_submit: float):
        self._service = service
        self._event = threading.Event()
        self._error: Optional[BaseException] = None
        self.done = False
        self.gid = -1
        self.dist = float("inf")
        self.gids: Optional[np.ndarray] = None
        self.dists: Optional[np.ndarray] = None
        self.n_within_cr = 0
        self.fq = 0
        self.t_submit = t_submit

    def _resolved(self) -> None:   # QueryPipeline retire hook
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> "AsyncQuery":
        """Block until resolved (requests a flush so a partial bucket
        cannot park this query forever).  Raises RuntimeError if the
        engine thread stops first."""
        if not self._event.is_set():
            self._service.flush()
            self._service._await(self._event, timeout,
                                 "query not resolved within timeout")
        if self._error is not None:
            raise self._error
        return self


class AsyncWrite:
    """Future for an admitted insert/delete/snapshot."""

    __slots__ = ("_service", "_event", "_value", "_error")

    def __init__(self, service: "AsyncLSHService"):
        self._service = service
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def _set(self, value) -> None:
        self._value = value
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until applied; raises RuntimeError if the engine thread
        stops first."""
        self._service._await(self._event, timeout,
                             "write not applied within timeout")
        if self._error is not None:
            raise self._error
        return self._value


class AsyncLSHService:
    """Non-blocking serving front-end over one ``DistributedLSHIndex``."""

    def __init__(self, index: DistributedLSHIndex, bucket_size: int = 64,
                 max_latency_ms: float = 25.0,
                 k_neighbors: Optional[int] = None, wal=None,
                 queue_depth: int = 256, admission: str = "block",
                 pipeline_depth: int = 2, clock=time.monotonic,
                 stats: Optional[ServiceStats] = None,
                 autostart: bool = True):
        if admission not in ("block", "reject"):
            raise ValueError(f"admission={admission!r} must be "
                             f"'block' or 'reject'")
        self.stats = ServiceStats() if stats is None else stats
        self._clock = clock
        # write path: the synchronous service IS the write path (WAL
        # validate-before-append, layout stats) -- queries never route
        # through it, so its bucket never fills
        self._writes = ShardedLSHService(
            index, bucket_size=bucket_size, max_latency_ms=float("inf"),
            k_neighbors=k_neighbors, wal=wal, clock=clock,
            stats=self.stats)
        self.pipeline = QueryPipeline(
            index, bucket_size, k_neighbors=k_neighbors,
            depth=pipeline_depth, clock=clock, stats=self.stats)
        self.index = index
        self.bucket_size = bucket_size
        self.max_latency_ms = max_latency_ms
        self.k_neighbors = self.pipeline.k_neighbors
        self.admission = admission
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._pending: List[AsyncQuery] = []
        self._pending_rows: List[np.ndarray] = []
        self._deadline: Optional[float] = None
        self._snapshots = None   # lazy persist.SnapshotWriter
        self._engine: Optional[threading.Thread] = None
        self._stopping = False
        self._closed = False
        if autostart:
            self.start()

    @property
    def wal(self):
        """The write path's WAL (attachable after construction, like the
        synchronous service's plain attribute)."""
        return self._writes.wal

    @wal.setter
    def wal(self, wal) -> None:
        self._writes.wal = wal

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._engine is not None and self._engine.is_alive()

    def _stopped(self) -> bool:
        """True once a started engine thread has ended (normally or not):
        nothing admitted after that is ever processed."""
        return self._engine is not None and not self._engine.is_alive()

    def _await(self, event: threading.Event, timeout: Optional[float],
               what: str) -> None:
        """Wait for ``event`` (at most ``timeout`` real seconds), never
        on an engine that stopped."""
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            left = None if end is None else end - time.monotonic()
            if event.wait(_POLL_S * 20 if left is None
                          else max(0.0, min(left, _POLL_S * 20))):
                return
            if self._stopped():
                if event.is_set():   # set just before the engine ended
                    return
                raise RuntimeError("the engine thread stopped")
            if left is not None and left <= _POLL_S * 20:
                raise TimeoutError(what)

    def start(self) -> None:
        """Start the engine thread (idempotent)."""
        if self._closed:
            raise RuntimeError("service is closed")
        if not self.running:
            engine = threading.Thread(
                target=self._engine_loop, name="lsh-engine", daemon=True)
            engine.start()   # published started: _stopped() reads it
            self._engine = engine

    def close(self, drain: bool = True) -> None:
        """Stop the engine (drains by default) and join all workers.

        Joins the background snapshot writer too, surfacing any write
        error raised off-thread.
        """
        if self._closed:
            return
        if self.running:
            if drain:
                self.drain()
            self._put(("stop", None), control=True)
            self._engine.join()
        self._closed = True
        if self._snapshots is not None:
            self._snapshots.join()

    def __enter__(self) -> "AsyncLSHService":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc[0] is None)

    # ------------------------------------------------------------------
    # Admission (producer side; any thread)
    # ------------------------------------------------------------------
    def _put(self, item, control: bool = False) -> None:
        """Admit one item.  Control items (flush/drain/stop) always
        block -- rejecting them would deadlock waiters."""
        if self._closed:
            raise RuntimeError("service is closed")
        if control or self.admission == "block":
            while True:   # backpressure, but never on a stopped engine
                try:
                    self._q.put(item, timeout=_POLL_S * 20)
                    break
                except queue.Full:
                    if self._stopped():
                        raise RuntimeError(
                            "the engine thread stopped") from None
        else:
            try:
                self._q.put_nowait(item)
            except queue.Full:
                self.stats.rejects += 1
                raise AdmissionFull(
                    f"admission queue full ({self._q.maxsize} items); "
                    f"retry or switch admission='block'") from None
        depth = self._q.qsize()
        if depth > self.stats.queue_peak:
            self.stats.queue_peak = depth

    def submit(self, q) -> AsyncQuery:
        return self.submit_batch(np.asarray(q, np.float32)[None])[0]

    def submit_batch(self, qs) -> List[AsyncQuery]:
        """Admit (b, d) queries; returns unresolved future handles."""
        qs = np.array(qs, np.float32, copy=True)   # engine owns the rows
        d = self.index.cfg.d
        if qs.ndim != 2 or qs.shape[1] != d:
            raise ValueError(f"queries must be (b, {d}), got {qs.shape}")
        now = self._clock()
        handles = [AsyncQuery(self, now) for _ in range(qs.shape[0])]
        self._put(("query", list(qs), handles))
        return handles

    def insert(self, points, gids=None) -> AsyncWrite:
        """Admit an insert batch; the future resolves to InsertResult."""
        fut = AsyncWrite(self)
        self._put(("insert", points, gids, fut))
        return fut

    def delete(self, gids) -> AsyncWrite:
        """Admit a delete batch; the future resolves to DeleteResult."""
        fut = AsyncWrite(self)
        self._put(("delete", gids, fut))
        return fut

    def snapshot(self, snap_dir: str, **kw) -> AsyncWrite:
        """Admit a snapshot: state is fetched on the engine thread (a
        consistent point in the op stream), the file write runs on the
        background writer.  Resolves to the checkpoint path, or None if
        skipped because one was already in flight."""
        fut = AsyncWrite(self)
        self._put(("snapshot", snap_dir, kw, fut))
        return fut

    def flush(self) -> None:
        """Ask the engine to answer everything admitted so far."""
        self._put(("flush", None), control=True)

    def drain(self) -> None:
        """Block until every admitted item has been fully processed."""
        if not self.running:
            raise RuntimeError("engine not running (autostart=False? "
                               "call start() first)")
        ev = threading.Event()
        self._put(("drain", ev), control=True)
        self._await(ev, None, "")

    @property
    def n_pending(self) -> int:
        """Queries admitted but not yet answered (approximate: the
        engine-side partial bucket; queued items are not counted)."""
        return len(self._pending)

    def shard_load(self) -> np.ndarray:
        return self.index.shard_load

    # ------------------------------------------------------------------
    # Engine (single consumer thread; owns the index)
    # ------------------------------------------------------------------
    def _engine_loop(self) -> None:
        if self.index.device.type == "cuda":
            # the current device is per thread: select the one the
            # index's tensors live on
            torch.cuda.set_device(self.index.stacked_params.A.device)
        while True:
            timeout: Optional[float] = None
            if self._pending:
                # deadline is on the injected clock; poll on the real
                # one so fake-clock tests still make progress
                timeout = _POLL_S
            elif self.pipeline.n_inflight:
                timeout = 0.0   # idle: retire eagerly
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                if (self._pending and self._deadline is not None
                        and self._clock() >= self._deadline):
                    self._submit_bucket("deadline")
                elif self.pipeline.n_inflight:
                    self.pipeline.retire_one()
                continue
            if item[0] == "stop":
                return
            try:
                self._handle(item)
            except BaseException as exc:   # noqa: BLE001 -- engine must
                self._fail_item(item, exc)  # survive a poisoned item

    def _handle(self, item) -> None:
        kind = item[0]
        if kind == "query":
            _, rows, handles = item
            if self._deadline is None and handles:
                self._deadline = (self._clock()
                                  + self.max_latency_ms / 1e3)
            self._pending.extend(handles)
            self._pending_rows.extend(rows)
            while len(self._pending) >= self.bucket_size:
                self._submit_bucket("full")
        elif kind == "insert":
            _, points, gids, fut = item
            self.pipeline.drain()   # write barrier: see _submit_bucket
            fut._set(self._writes.insert(points, gids=gids))
        elif kind == "delete":
            _, gids, fut = item
            self.pipeline.drain()
            fut._set(self._writes.delete(gids))
        elif kind == "snapshot":
            _, snap_dir, kw, fut = item
            fut._set(self._snapshot(snap_dir, **kw))
        elif kind == "flush":
            while self._pending:
                self._submit_bucket("manual")
            self.pipeline.drain()
        elif kind == "drain":
            _, ev = item
            while self._pending:
                self._submit_bucket("manual")
            self.pipeline.drain()
            ev.set()
        else:   # pragma: no cover -- admission only produces the above
            raise RuntimeError(f"unknown item kind {kind!r}")

    def _submit_bucket(self, reason: str) -> None:
        """Move up to one bucket from pending into the pipeline.

        Writes update the store in place; the pipeline retires every
        in-flight batch before a write applies (those batches were
        admitted earlier, so they must answer against the pre-write
        store anyway -- the barrier enforces exactly the synchronous
        ordering).  Queries pending but not yet submitted
        stay pending across a write, like the synchronous service.
        """
        take = min(len(self._pending), self.bucket_size)
        handles = self._pending[:take]
        rows = self._pending_rows[:take]
        del self._pending[:take], self._pending_rows[:take]
        self._deadline = (self._clock() + self.max_latency_ms / 1e3
                          if self._pending else None)
        try:
            self.pipeline.submit(rows, handles, reason=reason)
        except BaseException as exc:
            # a failed submit must not park its waiters forever (their
            # admitting item may already have been handled)
            for h in handles:
                h._fail(exc)
            raise

    def _snapshot(self, snap_dir: str, **kw):
        from repro_torch import persist   # local: avoid import cycle
        if self._snapshots is None:
            self._snapshots = persist.SnapshotWriter()
        path = self._snapshots.submit(self.index, snap_dir,
                                      wal=self.wal, **kw)
        if path is None:
            self.stats.snapshots_skipped += 1
        else:
            self.stats.snapshots += 1
        return path

    def _fail_item(self, item, exc: BaseException) -> None:
        """Resolve a failed item's waiters with the error."""
        kind = item[0]
        if kind == "query":
            for h in item[2]:
                h._fail(exc)
        elif kind in ("insert", "delete", "snapshot"):
            item[-1]._fail(exc)
        elif kind == "drain":
            item[1].set()
        # flush has no waiter; pending/in-flight handles of OTHER items
        # are untouched -- they resolve (or fail) with their own batch
