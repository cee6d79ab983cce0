"""The program's own spans and counters laid over a traced run's profile,
for the readers of ``portbench/metrics/`` that read them.

The program (``repro_torch.runtime.spans``) records its spans while a
profile is active, on the profile's clock: an event of ``prof.events()``
at ``t`` us began at ``trace_start_ns() + 1e3 * t`` on ``time.time_ns()``.
Only the spans inside the traced window are taken.  Then:

* each device event (a kernel, copy or fill: every CUDA event
  ``portbench/trace.py`` keeps) goes to the innermost span that was open
  on the host when it was LAUNCHED, not when it ran: the runtime call
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that shares its
  correlation id, or else the operator the profiler links it to.  One
  with neither is "unlinked"; one launched outside every span is
  "outside";
* each idle stretch of the card (no device event running) goes to the
  innermost span open during it.

``attribution(tr)`` is None where the profile holds no program spans: a
program without the recorder (the parent of the change that added it),
or an untraced run.  It is computed once a traced run and kept on the
tracer.  It is ``complete`` when the program dropped no record of the
window from its bounded buffers (``kept``) and no more than
``MAX_ASTRAY`` of the device time is unlinked or launched outside every
span; the readers of device and idle time read nothing otherwise, so
that a span lost or a launch left unlinked cannot pass for a gain.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

OUTSIDE = "outside"
UNLINKED = "unlinked"
MAX_ASTRAY = 0.01   # of the device time: unlinked plus outside


@dataclasses.dataclass
class Attribution:
    spans: List[Tuple[str, float, float, int]]   # name, start/end us, depth
    device_us: Dict[str, float]     # by innermost span at launch, OUTSIDE,
    #                                 UNLINKED
    idle_us: Dict[str, float]       # card idle by innermost span open
    counters: Dict[str, int]        # the program's, over the window
    device_total_us: float          # every device event's duration
    kept: bool                      # no record of the window dropped

    @property
    def complete(self) -> bool:
        astray = (self.device_us.get(UNLINKED, 0.0)
                  + self.device_us.get(OUTSIDE, 0.0))
        return self.kept and astray <= MAX_ASTRAY * self.device_total_us

    def device_pct(self, names, window_s: float) -> Optional[float]:
        """Device time launched inside spans named ``names`` (innermost)
        as a share of the window, in %; None unless complete."""
        if window_s <= 0 or not self.complete:
            return None
        us = sum(self.device_us.get(n, 0.0) for n in names)
        return 100.0 * us * 1e-6 / window_s


def _program():
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans


def _innermost(spans):
    """Boundaries and, for each stretch between two, the deepest span
    open there (None where none is)."""
    pts = sorted({s[1] for s in spans} | {s[2] for s in spans})
    label: List[Optional[str]] = [None] * max(len(pts) - 1, 0)
    for name, a, b, _ in sorted(spans, key=lambda s: s[3]):
        for k in range(bisect.bisect_left(pts, a),
                       bisect.bisect_left(pts, b)):
            label[k] = name
    return pts, label


def _merged(intervals):
    """The union of (start, end) intervals: sorted disjoint starts, ends
    and the busy time before each."""
    starts, ends = [], []
    for a, b in sorted(intervals):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    before = [0.0]
    for a, b in zip(starts, ends):
        before.append(before[-1] + b - a)
    return starts, ends, before


def _busy_within(merged, a: float, b: float) -> float:
    """Time of the union inside [a, b]."""
    starts, ends, before = merged

    def upto(t):
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0.0
        return before[i - 1] + min(ends[i - 1], t) - starts[i - 1]
    return upto(b) - upto(a)


def _launch_times(events, device):
    """Correlation id -> host time (us) of the runtime call that launched
    it, and operator id -> its start, for the linked fallback."""
    runtime, ops = {}, {}
    for e in events:
        if e.device_type == device:
            continue
        if e.name.startswith("cu"):
            runtime.setdefault(e.id, e.time_range.start)
        else:
            ops.setdefault(e.id, e.time_range.start)
    return runtime, ops


def attribution(tr) -> Optional[Attribution]:
    if hasattr(tr, "_program_spans"):
        return tr._program_spans
    out = None
    spans = _program()
    if spans is not None and getattr(tr, "prof", None) is not None:
        out = _attribute(tr, spans)
    tr._program_spans = out
    return out


def _attribute(tr, spans) -> Optional[Attribution]:
    from torch.autograd import DeviceType
    t0 = tr.prof.profiler.kineto_results.trace_start_ns()
    recs = [(s.name, (s.start_ns - t0) * 1e-3, (s.end_ns - t0) * 1e-3,
             s.depth) for s in spans.recorded(start_ns=t0)]
    if not recs:
        return None
    events = tr.prof.events()
    runtime, ops = _launch_times(events, DeviceType.CUDA)
    pts, label = _innermost(recs)

    def at(t):
        k = bisect.bisect_right(pts, t) - 1
        return label[k] if 0 <= k < len(label) else None

    device = collections.Counter()
    busy, total = [], 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        busy.append((a, b))
        total += b - a
        t = runtime.get(e.id)
        if t is None:
            t = ops.get(getattr(e, "linked_correlation_id", 0) or -1)
        name = UNLINKED if t is None else (at(t) or OUTSIDE)
        device[name] += b - a
    merged = _merged(busy)
    idle = collections.Counter()
    for k, name in enumerate(label):
        if name is not None:
            a, b = pts[k], pts[k + 1]
            idle[name] += (b - a) - _busy_within(merged, a, b)
    return Attribution(spans=recs, device_us=dict(device),
                       idle_us=dict(idle),
                       counters=spans.counters(start_ns=t0),
                       device_total_us=total, kept=spans.kept_since(t0))


def ratio_pct(tr, num: str, den: str) -> Optional[float]:
    """100 x counter ``num`` / counter ``den`` over the traced window;
    None where a record of the window was dropped."""
    att = attribution(tr)
    if att is None or not att.kept or not att.counters.get(den):
        return None
    return 100.0 * att.counters.get(num, 0) / att.counters[den]
