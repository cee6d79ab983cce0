"""The traced run: torch.profiler over a fixed number of steps, the
program's host-sync log, and recorders of the kernel launches' inputs.

The recorders replace three attributes of the program for the traced
steps only and restore them after: ``repro_torch.core.hashing.klh`` (the
hash kernel's module, through which every H and G is hashed) and
``repro_torch.kernels.ops.bucket_gather_cuda`` / ``bucket_search_cuda``
(the bucket kernels the per-shard scan calls).  They keep what the
roofline's work count needs (``portbench/roofline.py``) and call the
program's function unchanged.  The store columns a full scan reads are
copied at the launch (two small copies a launch, inside the traced
window): later inserts reuse tail slots.

Device time is the union of the intervals in which a kernel, copy or
fill ran, never their sum: concurrent work counts once.
"""
from __future__ import annotations

import collections
import time
import types

import numpy as np
import torch


class _HashProxy(types.SimpleNamespace):
    """Stands for ``repro_torch.kernels.lsh_hash`` inside
    ``core/hashing``: records each launch's shapes."""

    def __init__(self, klh, calls):
        super().__init__()
        self._klh, self._calls = klh, calls

    def __getattr__(self, name):
        return getattr(self._klh, name)

    def lsh_hash_cuda(self, x, a, b, **kw):
        d, K = a.shape[-2:]
        self._calls.append({
            "rows": x.numel() // max(d, 1), "d": d, "K": K,
            "x_bytes": x.element_size(),
            "param_bytes": (a.numel() + b.numel()) * 4,
            "table": kw.get("table") is not None})
        return self._klh.lsh_hash_cuda(x, a, b, **kw)


class Tracer:
    """``with Tracer() as tr:`` around the traced steps."""

    def __init__(self, device):
        self.dev = device
        self.calls = collections.defaultdict(list)

    # ------------------------------------------------------------------
    def _install(self):
        from repro_torch.core import hashing
        from repro_torch.kernels import ops
        self._saved = (hashing.klh, ops.bucket_gather_cuda,
                       ops.bucket_search_cuda)
        klh, gather, search = self._saved
        calls = self.calls
        hashing.klh = _HashProxy(klh, calls["lsh_hash"])

        def rec_gather(q, qsq, start, end, p, psq, gid, pvalid, cr2, *, K):
            calls["bucket_gather"].append({
                "d": q.shape[-1], "K": K, "start": start, "end": end,
                "pvalid": pvalid})
            return gather(q, qsq, start, end, p, psq, gid, pvalid, cr2, K=K)

        def rec_search(*, query, store, cr2, L, K=1):
            calls["bucket_search"].append({
                "d": query.q.shape[-1], "K": K, "probe": query.probe,
                "buckets": query.buckets, "table": query.table,
                "valid": store.valid,
                "store_table": store.table.clone(),
                "store_buckets": store.buckets.clone()})
            return search(query=query, store=store, cr2=cr2, L=L, K=K)

        ops.bucket_gather_cuda = rec_gather
        ops.bucket_search_cuda = rec_search

    def _uninstall(self):
        from repro_torch.core import hashing
        from repro_torch.kernels import ops
        hashing.klh, ops.bucket_gather_cuda, ops.bucket_search_cuda = \
            self._saved

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def __enter__(self):
        from repro_torch.analysis.device_pass import SyncLog
        from torch.profiler import ProfilerActivity, profile
        on_card = self.dev.type == "cuda"
        self._install()
        # the host-sync log exists on the card only
        self.synclog = SyncLog(peak=False).__enter__() if on_card else None
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))
        self.prof.__enter__()
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            self._sync()
            self.window_s = time.perf_counter() - self.t0
            self.prof.__exit__(*exc)
            if self.synclog is not None:
                self.synclog.__exit__(*exc)
        finally:
            self._uninstall()
        if exc[0] is None:
            self._read()
        return False

    # ------------------------------------------------------------------
    def _read(self):
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                dev.append((tr.start, tr.end, e.name))
            elif e.cpu_parent is None:
                host.append((tr.start, tr.end, e.name))
        dev.sort()
        self.device_events = dev          # (start us, end us, name)
        self.syncs = (len(self.synclog.syncs) if self.synclog is not None
                      else 0)
        self.busy_s, gaps = _union(dev)
        self.gaps = _label_gaps(gaps, host)

    def kernels(self):
        """Device events that are kernels (not copies or fills)."""
        return [e for e in self.device_events
                if not e[2].startswith(("Memcpy", "Memset"))]

    def device_time(self, names) -> tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds one of
        ``names``."""
        hit = [e for e in self.device_events
               if any(n in e[2] for n in names)]
        return len(hit), sum(b - a for a, b, _ in hit) * 1e-6

    def breakdown(self) -> dict:
        by = collections.Counter()
        for a, b, name in self.device_events:
            by[name] += (b - a) * 1e-6
        return {"device_ops": [[n[:120], s] for n, s in by.most_common(10)],
                "idle_gaps": [[n[:120], s] for n, s in
                              self.gaps.most_common(10)]}


def _union(events):
    """Seconds covered by the union of (start, end) intervals in us, and
    the gaps between them as (start, end) pairs."""
    busy, gaps, cur_a, cur_b = 0.0, [], None, None
    for a, b, _ in events:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    return busy * 1e-6, gaps


def _label_gaps(gaps, host):
    """Idle seconds by the top-level host operation running the longest
    during each gap ("host" where none ran)."""
    out = collections.Counter()
    if not gaps:
        return out
    host.sort()
    starts = np.array([h[0] for h in host]) if host else np.zeros(0)
    for a, b in gaps:
        best, name = 0.0, "host (no operation)"
        i = int(np.searchsorted(starts, b))
        for h in host[max(0, i - 64):i]:
            ov = min(b, h[1]) - max(a, h[0])
            if ov > best:
                best, name = ov, h[2]
        out[name] += (b - a) * 1e-6
    return out
