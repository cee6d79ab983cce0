"""Spans and counters inside the port: where a call's time and rows go.

``span(name)`` is a context manager around one stage of the program and
``count(name, n)`` adds ``n`` to a named counter.  Both record only while
recording is on: while a torch.profiler profile is active, or inside
``recording()``.  The profile's flag is the one torch keeps for fast
checks from Python, ``torch.autograd.profiler._is_profiler_enabled``: it
holds for every thread, where ``torch.autograd._profiler_enabled()`` is
true only in the thread that started the profile (a serving engine
thread would record nothing).  That name is private, so it is looked up
once, at import; a torch without it falls back to
``_profiler_enabled()``, and then records under a profile only in the
profiling thread.  Off, ``span`` returns one shared object whose enter
and exit do nothing: a flag check, with no allocation, no string
formatting and no clock read.

On, a span keeps ``Span(name, start_ns, end_ns, depth)``: ``depth`` is
the number of spans its thread had open around it, so the deepest span
open at an instant is the innermost.  The clock is ``time.time_ns()``
(CLOCK_REALTIME), the clock of torch.profiler's events, on the CPU build
and on the H100's: an event of ``prof.events()`` at ``t`` us began at
``prof.profiler.kineto_results.trace_start_ns() + 1e3 * t`` on it.  So a
reader lays the spans over a profile without a second clock.  A counter
increment keeps its time too, so that a reader takes the counts of a
profile's window alone.  The last ``MAX_RECORDS`` spans and as many
counter increments are kept; ``kept_since(t)`` says whether every
record made since ``t`` still is.

A span never syncs, launches a kernel or dispatches an aten op, and
emits no profiler event (no ``record_function``, no NVTX range): a
profile holds the same events with the spans as without.  Spans are read
in process, by ``recorded()`` and ``summary()``.

The names the program uses (``core/index.py``, ``serving/``), each the
innermost span where it nests:

  lsh.upload                     a query batch's copy to the device
  lsh.dispatch[.offsets|.hash|.route]   stage 1 (the send side)
  lsh.exchange                   a send buffer's build and its exchange
  lsh.scan[.live_rows|.offsets|.hash|.probe|.bucket|.union]   stage 2
  lsh.return[.merge]             stage 3
  lsh.fetch                      the answers' copy to the host
  serve.submit, serve.retire     the query pipeline (``serving/pipeline``)
  serve.flush                    the synchronous service's query step

and the counters, each from numbers the program already has on the host:
``lsh.dispatch.rows_live`` / ``lsh.dispatch.rows_shipped`` (routed rows
sent / the send buffers' slots), ``lsh.scan.rows_live`` /
``lsh.scan.rows_processed`` (routed rows kept on the receive side / the
rows whose offsets it regenerates, padded to the busiest shard).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 16


def _profile_flag():
    """The reader of the profile's flag: torch's global for every thread
    where this torch has it, else the profiling thread's own."""
    if hasattr(_profiler, "_is_profiler_enabled"):
        return lambda: _profiler._is_profiler_enabled
    return torch.autograd._profiler_enabled


_profiling = _profile_flag()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    depth: int


_spans: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_counts: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_local = threading.local()
_lock = threading.Lock()
_forced = 0


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "start", "depth")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.depth = getattr(_local, "depth", 0)
        _local.depth = self.depth + 1
        self.start = time.time_ns()
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.depth = self.depth
        _spans.append(Span(self.name, self.start, end, self.depth))
        return False


def span(name: str):
    """``with span("lsh.scan"):`` around one stage of the program."""
    if _forced or _profiling():
        return _On(name)
    return _OFF


def count(name: str, n) -> None:
    """Add ``n``, a host number or the sum of a host array, to the
    counter ``name``; the sum is taken only while recording."""
    if _forced or _profiling():
        _counts.append((name, time.time_ns(), int(np.sum(n))))


@contextlib.contextmanager
def recording():
    """Record with no profile active (the operator's switch)."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def _within(t0: int, t1: int, start_ns: Optional[int],
            end_ns: Optional[int]) -> bool:
    return ((start_ns is None or t0 >= start_ns)
            and (end_ns is None or t1 <= end_ns))


def recorded(start_ns: Optional[int] = None,
             end_ns: Optional[int] = None) -> List[Span]:
    """The kept spans that lie inside [start_ns, end_ns], oldest first."""
    return [s for s in list(_spans)
            if _within(s.start_ns, s.end_ns, start_ns, end_ns)]


def counters(start_ns: Optional[int] = None,
             end_ns: Optional[int] = None) -> Dict[str, int]:
    """Each counter's total over the increments made in the interval."""
    out: Dict[str, int] = {}
    for name, t, n in list(_counts):
        if _within(t, t, start_ns, end_ns):
            out[name] = out.get(name, 0) + n
    return out


def kept_since(start_ns: int) -> bool:
    """Whether every span and counter increment made since ``start_ns``
    is still kept: false once a full buffer has dropped one of them."""
    for buf, end in ((_spans, 2), (_counts, 1)):
        recs = list(buf)
        if len(recs) >= MAX_RECORDS and recs[0][end] >= start_ns:
            return False
    return True


def summary(start_ns: Optional[int] = None,
            end_ns: Optional[int] = None) -> dict:
    """Host ms and calls by span name, and the counters, over the
    interval."""
    ms: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for s in recorded(start_ns, end_ns):
        ms[s.name] = ms.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-6
        calls[s.name] = calls.get(s.name, 0) + 1
    return {"host_ms": ms, "calls": calls,
            "counters": counters(start_ns, end_ns)}


def clear() -> None:
    """Forget every kept span and counter increment."""
    _spans.clear()
    _counts.clear()
