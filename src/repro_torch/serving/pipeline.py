"""Depth-bounded micro-batch query pipeline over the staged index.

``DistributedLSHIndex`` exposes the query step as three separately
invocable stages (``query_dispatch`` / ``query_scan`` / ``query_return``)
cut at its two exchange boundaries.  On the card each stage call only
ENQUEUES kernels on the pipeline's stream, so batch i+1's stages can be
issued while batch i's are still running:

    batch i   : dispatch | bucket scan  | return + merge
    batch i+1 :          | dispatch     | bucket scan | return ...

and the host side (staging the next bucket, fetching a retired bucket's
answers) overlaps device work.  The host waits in ``retire_one``
(synchronising on the oldest batch's event) and wherever a stage itself
reads a value back (the scan reads its live-row count once).

Staging: ``depth`` pinned host slots, used round-robin.  A bucket is
written into its slot and copied to the card with ``non_blocking=True``;
that copy reads the slot AFTER ``submit`` returns.  ``submit`` first
retires batches until fewer than ``depth`` are in flight, and retiring
synchronises on the event recorded at the end of the batch, so the batch
that last staged through the slot (``depth`` submissions ago) has run,
its copy included, before the slot is refilled (default 2, double
buffering).  This is the port's form of the reference's donation rule.  All stages run on one named stream, the device's default stream
(``self.stream``: index writes run there too), and the events are
recorded on it.

Results are bitwise those of the synchronous ``flush`` path: the stages
are the fused query cut at its exchanges, and retirement applies the
same numpy post-processing in submission order (tested).

``submit`` and ``retire_one`` run inside the spans ``serve.submit`` and
``serve.retire`` (``runtime/spans.py``), and a retire counts the
dispatch's live routed rows as the index's own fetch does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.index import DistributedLSHIndex
from repro_torch.runtime import spans
from repro_torch.serving.service import ServiceStats


@dataclasses.dataclass
class _InFlight:
    """One submitted micro-batch: device outputs + its query handles."""
    handles: list                 # per-query handle objects (resolved late)
    topd: torch.Tensor            # (bucket, K) squared dists (device)
    topg: torch.Tensor            # (bucket, K) gids (device)
    emit: torch.Tensor            # (bucket,) emit counts (device)
    fq: torch.Tensor              # (S, bucket/S) routed rows (device)
    drops: torch.Tensor           # (S,) capacity drops (device)
    done: Optional[torch.cuda.Event]   # recorded after query_return
    take: int                     # live queries (rest is padding)
    reason: str                   # what triggered the submit (stats key)
    t_submit: float               # pipeline clock at submit


class QueryPipeline:
    """Depth-bounded in-flight query batches over the staged index.

    ``submit`` stages one bucket and enqueues all three stages (it
    retires the oldest batch first if the pipeline is full).
    ``retire_one``/``drain`` fetch answers and resolve handles.  Handle
    objects need the ``PendingQuery`` attribute surface
    (gids/dists/gid/dist/n_within_cr/fq/done/t_submit) plus an optional
    ``_resolved()`` hook (used by the async front-end to wake waiters).
    """

    def __init__(self, index: DistributedLSHIndex, bucket_size: int,
                 k_neighbors: Optional[int] = None, depth: int = 2,
                 clock=time.monotonic,
                 stats: Optional[ServiceStats] = None):
        S = index.cfg.n_shards
        if bucket_size % S:
            raise ValueError(
                f"bucket_size={bucket_size} must divide by n_shards={S}")
        if depth < 1:
            raise ValueError(f"depth={depth} must be >= 1")
        self.index = index
        self.bucket_size = bucket_size
        self.k_neighbors = (index.k_neighbors if k_neighbors is None
                            else k_neighbors)
        self.depth = depth
        self.stats = ServiceStats() if stats is None else stats
        self._clock = clock
        on_card = index.device.type == "cuda"
        # the stream every stage runs on and every event is recorded on
        self.stream = (torch.cuda.default_stream(index.device) if on_card
                       else None)
        # one staging slot per in-flight batch (see the module docstring
        # for why the retire-before-submit bound makes a refill safe)
        self._slots = [torch.zeros((bucket_size, index.cfg.d),
                                   dtype=torch.float32, pin_memory=on_card)
                       for _ in range(depth)]
        self._slot = 0
        self._inflight: deque[_InFlight] = deque()
        # device-time accounting: union of [submit, fetch-done] intervals
        # (in-flight batches overlap; summing per-batch spans would
        # double-count the overlapped time the pipeline exists to create)
        self._busy_until = 0.0

    @property
    def n_inflight(self) -> int:
        return len(self._inflight)

    def submit(self, rows: List[np.ndarray], handles: list,
               reason: str = "manual") -> None:
        """Stage one bucket (<= bucket_size rows) and enqueue its stages.

        rows[i] is handle[i]'s (d,) float32 query.  Shorter-than-bucket
        submissions are zero-padded (every batch has the bucket's shape).
        Blocks to retire the oldest batch when ``depth`` batches are
        already in flight, and wherever a stage reads a value back.
        """
        take = len(handles)
        if not 0 < take <= self.bucket_size:
            raise ValueError(f"got {take} handles for bucket_size="
                             f"{self.bucket_size}")
        with spans.span("serve.submit"):
            while len(self._inflight) >= self.depth:
                self.retire_one()
            s = self._slot
            buf = self._slots[s].numpy()
            buf[:take] = rows
            buf[take:] = 0.0   # re-zero the pad region (slot is reused)
            t0 = self._clock()
            idx = self.index
            ctx = (torch.cuda.stream(self.stream) if self.stream is not None
                   else contextlib.nullcontext())
            with ctx:
                q = self._slots[s].to(idx.device, non_blocking=True)
                disp = idx.query_dispatch(q)
                scanned = idx.query_scan(disp, k_neighbors=self.k_neighbors)
                topd, topg, emit = idx.query_return(scanned)
                done = None
                if self.stream is not None:
                    done = torch.cuda.Event()
                    done.record(self.stream)
            self._inflight.append(_InFlight(
                handles=handles, topd=topd, topg=topg, emit=emit,
                fq=disp.fq, drops=disp.drops, done=done, take=take,
                reason=reason, t_submit=t0))
            self._slot = (s + 1) % self.depth
            if len(self._inflight) > self.stats.inflight_peak:
                self.stats.inflight_peak = len(self._inflight)

    def retire_one(self) -> int:
        """Fetch + resolve the OLDEST in-flight batch (blocks on its
        event).

        Returns the number of live queries answered (0 if none in
        flight).  Handle resolution is bit-identical to the synchronous
        flush: same sqrt/inf conversion, same per-handle numpy slices.
        """
        if not self._inflight:
            return 0
        fl = self._inflight.popleft()
        with spans.span("serve.retire"):
            if fl.done is not None:
                fl.done.synchronize()           # the batch has run
            topd = fl.topd.cpu().numpy()
            topg = fl.topg.cpu().numpy()
            emit = fl.emit.cpu().numpy()
            fq = fl.fq.cpu().numpy().reshape(-1)
            drops = int(fl.drops.sum())
            now = self._clock()
            dists = np.sqrt(np.where(topd < np.float32(3e38), topd, np.inf))

            st = self.stats
            for i, h in enumerate(fl.handles):
                h.gids = topg[i].copy()
                h.dists = dists[i].copy()
                h.gid = int(h.gids[0])
                h.dist = float(h.dists[0])
                h.n_within_cr = int(emit[i])
                h.fq = int(fq[i])
                h.done = True
                st.record_latency((now - h.t_submit) * 1e3)
                resolved = getattr(h, "_resolved", None)
                if resolved is not None:
                    resolved()

            st.queries += fl.take
            st.batches += 1
            st.pad_rows += self.bucket_size - fl.take
            st.drops += drops
            st.routed_rows += int(fq[:fl.take].sum())
            spans.count("lsh.dispatch.rows_live", fq)
            # busy-interval union: overlapped device time is counted once
            st.query_time_s += now - max(fl.t_submit, self._busy_until)
            self._busy_until = now
            key = f"flush_{fl.reason}"
            setattr(st, key, getattr(st, key) + 1)
            return fl.take

    def drain(self) -> int:
        """Retire every in-flight batch; returns total queries answered."""
        total = 0
        while self._inflight:
            total += self.retire_one()
        return total
