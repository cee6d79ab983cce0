"""The readers of the program's spans and counters (``portbench/spans.py``
and its five metrics) on a small synthetic profile: device time goes to
the innermost span open at its launch, idle time to the innermost span
open during it, the counters give the occupancies, and every reader
reads nothing where the program records no spans (the parent commit's
program, or a profile before the recorder existed).  The readers of
device and idle time read nothing either where more than 1% of the
device time is unlinked or outside every span, and none reads where the
program dropped a record of the window.  Then a tiny traced run on the
CPU reports all five."""
import types

import pytest
from torch.autograd import DeviceType

from portbench import spans as ps
from portbench import spec
from repro_torch.runtime import spans as rs

T0 = 1_700_000_000_000_000_000
NEW = ("offsets_device_pct.batch", "exchange_device_pct.batch",
       "dispatch_row_occupancy.batch", "scan_row_occupancy.batch",
       "idle_in_query_pct.batch")


def ev(name, a, b, id_, device=DeviceType.CUDA, linked=0):
    return types.SimpleNamespace(
        name=name, id=id_, device_type=device, linked_correlation_id=linked,
        time_range=types.SimpleNamespace(start=a, end=b))


def us(t):
    return T0 + int(t * 1000)


SPANS = [rs.Span("lsh.dispatch", us(10), us(100), 0),
         rs.Span("lsh.dispatch.offsets", us(20), us(40), 1),
         rs.Span("lsh.exchange", us(50), us(90), 1),
         rs.Span("lsh.scan", us(110), us(300), 0),
         rs.Span("lsh.scan.offsets", us(120), us(200), 1)]
COUNTERS = {"lsh.dispatch.rows_live": 25, "lsh.dispatch.rows_shipped": 1000,
            "lsh.scan.rows_live": 30, "lsh.scan.rows_processed": 40}
CPU = DeviceType.CPU
EVENTS = [
    ev("cudaLaunchKernel", 25, 26, 1, CPU), ev("k_offsets", 30, 60, 1),
    ev("cudaLaunchKernel", 55, 56, 2, CPU), ev("k_exchange", 60, 80, 2),
    ev("cudaLaunchKernel", 125, 126, 3, CPU), ev("k_scan_off", 130, 250, 3),
    ev("cudaLaunchKernel", 400, 401, 4, CPU), ev("k_after", 400, 410, 4),
    # no runtime call: the operator it is linked to, inside lsh.scan
    ev("aten::argsort", 205, 215, 77, CPU), ev("k_linked", 280, 290, 5,
                                               linked=77),
    ev("k_orphan", 295, 300, 6)]
# every device event launched inside a span: attribution complete
LINKED = [e for e in EVENTS if e.name not in ("k_after", "k_orphan")]
DEVICE_READERS = NEW[:2] + NEW[4:]


def tracer(events=EVENTS, window_s=1e-3):
    results = types.SimpleNamespace(trace_start_ns=lambda: T0)
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results),
        events=lambda: events)
    return types.SimpleNamespace(prof=prof, window_s=window_s)


@pytest.fixture
def program(monkeypatch):
    """The program's recorder holding SPANS and COUNTERS, and a span
    before the profile's start that no reader may take."""
    early = rs.Span("lsh.scan.offsets", T0 - 5000, T0 - 1000, 1)

    def recorded(start_ns=None, end_ns=None):
        return [s for s in [early] + SPANS
                if start_ns is None or s.start_ns >= start_ns]

    monkeypatch.setattr(rs, "recorded", recorded)
    monkeypatch.setattr(rs, "counters",
                        lambda start_ns=None, end_ns=None: dict(COUNTERS))
    return rs


def test_attribution_by_launch_and_idle_by_span(program):
    att = ps.attribution(tracer())
    assert att.device_us == {"lsh.dispatch.offsets": 30, "lsh.exchange": 20,
                             "lsh.scan.offsets": 120, "lsh.scan": 10,
                             ps.OUTSIDE: 10, ps.UNLINKED: 5}
    # attribution is complete: every device event is somewhere
    assert sum(att.device_us.values()) == att.device_total_us == 195
    assert att.idle_us == pytest.approx({
        "lsh.dispatch": 20, "lsh.dispatch.offsets": 10, "lsh.exchange": 10,
        "lsh.scan": 45, "lsh.scan.offsets": 10})
    assert [s[0] for s in att.spans] == [s.name for s in SPANS]
    assert att.counters == COUNTERS
    # 15 of 195 us unlinked or outside: past 1%, so not complete
    assert att.kept and not att.complete
    assert ps.attribution(tracer(LINKED)).complete


def test_the_five_readers(program):
    got = {m: spec.metric_reader(m)(tracer(LINKED)) for m in NEW}
    assert got == pytest.approx({
        "offsets_device_pct.batch": 15.0, "exchange_device_pct.batch": 2.0,
        "dispatch_row_occupancy.batch": 2.5,
        "scan_row_occupancy.batch": 75.0, "idle_in_query_pct.batch": 10.0})


@pytest.mark.parametrize("astray_us, complete", [
    (1.8, True), (1.9, False)])
@pytest.mark.parametrize("kind", ["unlinked", "outside"])
def test_readers_read_nothing_past_one_pct_astray(program, kind, astray_us,
                                                  complete):
    """1.8 us of 181.8 is under 1% of the device time, 1.9 of 181.9
    over it: an unlinked event (no runtime call, no operator) or one
    launched after every span."""
    if kind == "unlinked":
        extra = [ev("k_astray", 500, 500 + astray_us, 9)]
    else:
        extra = [ev("cudaLaunchKernel", 500, 501, 9, CPU),
                 ev("k_astray", 500, 500 + astray_us, 9)]
    att = ps.attribution(tracer(LINKED + extra))
    assert att.device_us[kind] == pytest.approx(astray_us)
    assert att.complete is complete
    got = {m: spec.metric_reader(m)(tracer(LINKED + extra)) for m in NEW}
    assert all((got[m] is None) is not complete for m in DEVICE_READERS)
    # the counters do not depend on the device time's attribution
    assert got["dispatch_row_occupancy.batch"] == pytest.approx(2.5)


def test_readers_read_nothing_where_records_were_dropped(program,
                                                         monkeypatch):
    seen = []
    monkeypatch.setattr(rs, "kept_since",
                        lambda t: seen.append(t) or False)
    att = ps.attribution(tracer(LINKED))
    assert seen == [T0] and not att.kept and not att.complete
    assert all(spec.metric_reader(m)(tracer(LINKED)) is None for m in NEW)


def test_readers_read_nothing_without_program_spans(monkeypatch, program):
    # a profile in which the program recorded nothing
    monkeypatch.setattr(rs, "recorded", lambda start_ns=None, end_ns=None:
                        [])
    assert all(spec.metric_reader(m)(tracer()) is None for m in NEW)
    # a program without the recorder: the parent commit's
    monkeypatch.setattr(ps, "_program", lambda: None)
    assert all(spec.metric_reader(m)(tracer()) is None for m in NEW)


def test_the_attribution_is_computed_once_a_run(program, monkeypatch):
    tr = tracer()
    first = ps.attribution(tr)
    monkeypatch.setattr(ps, "_attribute", lambda *a: pytest.fail("again"))
    assert ps.attribution(tr) is first


def test_a_tiny_traced_run_reports_the_five(tiny):
    from portbench import run
    cell = tiny("random-1m.batch")
    res = run.run_cell(cell, 2**31 + 11, 1.0, True, device="cpu")
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m)
    assert 0 < m["dispatch_row_occupancy.batch"] <= 100
    assert 0 < m["scan_row_occupancy.batch"] <= 100
