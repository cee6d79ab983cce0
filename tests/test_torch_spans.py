"""The port's spans and counters (``repro_torch.runtime.spans``) on the CPU.

  * a query (fused and staged) records the named spans of
    ``core/index.py`` in their documented nesting, and the counters equal
    hand counts from the same call: ``fq`` and the exchange's slots, the
    live routed rows counted from the dispatch's receive buffer;
  * the query pipeline and the services record ``serve.*`` around the
    stages, from the engine thread too while a profile is active;
  * with recording off nothing is recorded, a span is one shared object
    and a counter sums nothing; a torch without the profile's global flag
    falls back to the profiling thread's; a full buffer tells that it
    dropped records;
  * under torch.profiler no aten op straddles a span's edge on the
    profile's clock (``time.time_ns()`` against ``trace_start_ns``), and
    an op run inside a span lies inside it;
  * the contract gate's trace pass counts the same ops, exchanges and
    flatness with recording on as off, and the lint passes on the
    instrumented hot scopes.
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import check, load_contracts, repo_root, repolint
from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme
from repro_torch.core.index import IMAX, first_occurrence_mask
from repro_torch.runtime import spans
from repro_torch.serving import (AsyncLSHService, QueryPipeline,
                                 ShardedLSHService)
from test_torch_cuda import one_torch_thread  # noqa: F401

N, M, D, S = 512, 64, 16, 4

QUERY = {  # span -> the span it sits in (None: outermost)
    "lsh.upload": None, "lsh.dispatch": None, "lsh.scan": None,
    "lsh.return": None, "lsh.fetch": None,
    "lsh.dispatch.offsets": "lsh.dispatch",
    "lsh.dispatch.hash": "lsh.dispatch",
    "lsh.dispatch.route": "lsh.dispatch",
    "lsh.scan.live_rows": "lsh.scan", "lsh.scan.offsets": "lsh.scan",
    "lsh.scan.hash": "lsh.scan", "lsh.scan.probe": "lsh.scan",
    "lsh.scan.bucket": "lsh.scan", "lsh.scan.union": "lsh.scan",
    "lsh.return.merge": "lsh.return"}
STAGES = ("lsh.upload", "lsh.dispatch", "lsh.scan", "lsh.return",
          "lsh.fetch")


def make_index(T=1, S=S):
    cfg = LSHConfig(d=D, k=4, W=1.2, r=0.3, c=2.0, L=6, n_shards=S,
                    scheme=Scheme.LAYERED, seed=0, n_tables=T)
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((N, D)) / np.sqrt(D)).astype(np.float32)
    q = (data[rng.integers(0, N, M)] + rng.standard_normal((M, D)).astype(
        np.float32) * np.float32(0.3 / np.sqrt(D))).astype(np.float32)
    idx = DistributedLSHIndex(cfg, device="cpu", k_neighbors=3)
    idx.build(data, capacity=idx._store_capacity(2 * N * T))
    return idx, data, q


@pytest.fixture
def recorder():
    spans.clear()
    yield spans
    spans.clear()


def parents(recs):
    """Each span's enclosing span (by depth and interval), by name."""
    out = {}
    for s in recs:
        up = [p for p in recs if p.depth == s.depth - 1
              and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns]
        assert len(up) == (1 if s.depth else 0), s
        out.setdefault(s.name, set()).add(up[0].name if up else None)
    return out


def live_routed_rows(idx, q):
    """The receive side's live rows, counted from the dispatch's buffer:
    (rows kept after the per-(query, table) dedupe, by shard)."""
    disp = idx.query_dispatch(q)
    d, T = idx.cfg.d, idx.cfg.n_tables
    rid, rtab = disp.recv[..., d], disp.recv[..., d + 1]
    valid = rid != IMAX
    kept = first_occurrence_mask(torch.where(valid, rid * T + rtab, IMAX),
                                 valid)
    return kept.sum(dim=-1).numpy()


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("entry", ["query", "query_staged"])
def test_query_records_its_stages_and_counts_its_rows(recorder, entry, T):
    idx, _, q = make_index(T)
    kept = live_routed_rows(idx, q)
    recorder.clear()
    with spans.recording():
        res = getattr(idx, entry)(q)
    recs = spans.recorded()
    got = parents(recs)
    want = {k: {v} for k, v in QUERY.items()}
    want["lsh.exchange"] = {"lsh.dispatch", "lsh.return"}
    assert got == want
    # the stages in order, each once, none overlapping
    top = [s for s in recs if s.depth == 0]
    assert [s.name for s in sorted(top, key=lambda s: s.start_ns)] == \
        list(STAGES)
    assert all(a.end_ns <= b.start_ns for a, b in zip(top, top[1:]))
    Cq = idx._query_capacity(M // S)
    assert spans.counters() == {
        "lsh.dispatch.rows_live": int(res.fq.sum()),
        "lsh.dispatch.rows_shipped": S * S * Cq,
        "lsh.scan.rows_live": int(kept.sum()),
        "lsh.scan.rows_processed": S * int(kept.max())}
    # the received rows before the dedupe bound the live ones
    assert res.query_load.sum() >= kept.sum() > 0
    assert res.fq.sum() == res.query_load.sum()
    summ = spans.summary()
    assert summ["calls"]["lsh.exchange"] == 2
    assert set(summ["host_ms"]) == set(want)
    assert summ["counters"] == spans.counters()


def test_pipeline_and_services_record_their_steps(recorder):
    idx, _, q = make_index()
    pipe = QueryPipeline(idx, bucket_size=M, depth=2)

    class Handle:
        t_submit = 0.0

    with spans.recording():
        handles = [Handle() for _ in range(M)]
        pipe.submit(list(q), handles)
        pipe.submit(list(q), [Handle() for _ in range(M)])
        pipe.submit(list(q), [Handle() for _ in range(M)])
        pipe.drain()
    got = parents(spans.recorded())
    assert got["serve.submit"] == {None}
    # the third submit retires the oldest batch first
    assert got["serve.retire"] == {None, "serve.submit"}
    assert got["lsh.dispatch"] == {"serve.submit"}
    assert "lsh.fetch" not in got
    fq = sum(h.fq for h in handles)
    c = spans.counters()
    assert c["lsh.dispatch.rows_live"] == 3 * fq
    assert c["lsh.dispatch.rows_shipped"] == 3 * S * S * idx._query_capacity(
        M // S)
    recorder.clear()
    svc = ShardedLSHService(idx, bucket_size=M)
    with spans.recording():
        svc.submit_batch(q)
    got = parents(spans.recorded())
    assert got["serve.flush"] == {None}
    assert got["lsh.fetch"] == {"serve.flush"}


def test_engine_thread_records_under_a_profile(recorder):
    """A profile turns recording on in every thread: the async service's
    engine thread runs the stages."""
    idx, _, q = make_index()
    with AsyncLSHService(idx, bucket_size=M, pipeline_depth=2) as svc:
        with profile(activities=[ProfilerActivity.CPU]):
            for h in svc.submit_batch(q):
                h.result(timeout=60)
            assert spans.span("a") is not spans.span("a")
        assert spans.span("a") is spans.span("b")
    names = {s.name for s in spans.recorded()}
    assert {"serve.submit", "serve.retire", "lsh.dispatch",
            "lsh.scan", "lsh.return"} <= names


def test_recording_off_records_nothing(recorder):
    idx, data, q = make_index()
    # off, a span is one shared object that records nothing
    assert spans.span("a") is spans.span("b")
    idx.query(q)
    idx.query_staged(q)
    idx.insert(data[:8])
    idx.delete([1, 2])
    assert spans.recorded() == [] and spans.counters() == {}
    assert spans.summary() == {"host_ms": {}, "calls": {}, "counters": {}}
    with spans.recording():
        with spans.recording():
            pass
        assert spans.span("a") is not spans.span("a")
    assert spans.span("a") is spans.span("b")


def test_counters_sum_nothing_when_off(recorder):
    class Rows:
        def sum(self, *a, **k):
            raise AssertionError("summed with recording off")
    spans.count("lsh.dispatch.rows_live", Rows())
    assert spans.counters() == {}
    with spans.recording():
        spans.count("rows", np.arange(5, dtype=np.int32))
        spans.count("rows", 3)
    assert spans.counters() == {"rows": 13}


def test_flag_falls_back_without_torchs_global(recorder, monkeypatch):
    from torch.autograd import profiler as tprof
    assert spans._profile_flag()() is False
    monkeypatch.delattr(tprof, "_is_profiler_enabled")
    flag = spans._profile_flag()
    assert flag is torch.autograd._profiler_enabled
    monkeypatch.setattr(spans, "_profiling", flag)
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag()
        with spans.span("a"):
            pass
    assert not flag()
    with spans.span("b"):
        pass
    assert [s.name for s in spans.recorded()] == ["a"]


def test_kept_since_tells_a_dropped_record(recorder):
    import time
    t0 = time.time_ns()
    with spans.recording():
        for _ in range(spans.MAX_RECORDS - 1):
            spans.count("c", 1)
        assert spans.kept_since(t0)
        spans.count("c", 1)
        spans.count("c", 1)
    assert not spans.kept_since(t0)
    assert spans.kept_since(time.time_ns() + 1)
    spans.clear()
    with spans.recording():
        for _ in range(spans.MAX_RECORDS + 1):
            with spans.span("x"):
                pass
    assert not spans.kept_since(t0)


def test_memory_is_bounded(recorder):
    with spans.recording():
        for i in range(spans.MAX_RECORDS + 10):
            with spans.span("x"):
                pass
            spans.count("c", 1)
    recs = spans.recorded()
    assert len(recs) == spans.MAX_RECORDS
    assert spans.counters() == {"c": spans.MAX_RECORDS}
    assert all(s.depth == 0 and s.start_ns <= s.end_ns for s in recs)


def test_spans_lie_on_the_profiles_clock(recorder):
    """Spans against the profile's own events: an op run inside a span
    lies inside it, and no op of a query straddles a span's edge."""
    idx, _, q = make_index()
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("probe.mm"):
            x @ x
        with spans.span("probe.sort"):
            torch.sort(x.reshape(-1))
        idx.query(q)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    recs = {}
    for s in spans.recorded(start_ns=t0):
        recs.setdefault(s.name, []).append(
            ((s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3))
    events = prof.events()

    def inside(name, span):
        (a, b), = recs[span]
        hit = [e for e in events if e.name == name]
        assert hit, name
        return any(a <= e.time_range.start and e.time_range.end <= b
                   for e in hit)
    assert inside("aten::mm", "probe.mm")
    assert not inside("aten::mm", "probe.sort")
    assert inside("aten::sort", "probe.sort")
    edges = sorted(t for v in recs.values() for iv in v for t in iv)
    ops = [e for e in events if e.cpu_parent is None
           and e.name.startswith("aten::")]
    assert len(ops) > 100
    for e in ops:
        a, b = e.time_range.start, e.time_range.end
        assert not any(a < t < b for t in edges), (e.name, a, b)
    # every stage's ops lie in its span
    (a, b), = recs["lsh.scan"]
    assert any(a <= e.time_range.start and e.time_range.end <= b
               for e in ops if e.name == "aten::argsort")


def test_gate_counts_the_same_with_recording_on(recorder):
    """The trace pass sees the same ops, exchanges, largest tensors and
    flatness with recording on as off; the lint holds on the index's
    instrumented hot scopes."""
    contracts = load_contracts()
    dev = torch.device("cpu")
    off, on = {}, {}
    assert check._run_trace(contracts, dev, None, off) == []
    with spans.recording():
        assert check._run_trace(contracts, dev, None, on) == []
    assert spans.recorded()
    assert on["trace"]["flatness"] == off["trace"]["flatness"]
    for phase, by_T in off["trace"]["phases"].items():
        for t, rep in by_T.items():
            other = on["trace"]["phases"][phase][t]
            for key in ("ops", "collectives", "kernels",
                        "max_intermediate", "wire"):
                assert other[key] == rep[key], (phase, t, key)
    cfg = contracts["repolint"]
    allowed = contracts["host_syncs"]["allowed"]
    used = set()
    index = "src/repro_torch/core/index.py"
    assert repolint.scan_files([f"{repo_root()}/{index}"], cfg,
                               rel_root=repo_root(), allowed=allowed,
                               used=used) == []
    assert used == {"insert-fitted-rows", "insert-high-water",
                    "insert-stats", "scan-live-rows", "delete-counts"}
    for fn in cfg["hot_functions"][index]:
        assert fn.rsplit(".", 1)[1] in {"_insert", "_delete", "_dispatch",
                                        "_scan", "_return"}


def test_threads_keep_their_own_depth(recorder):
    errors = []

    def work(name):
        try:
            for _ in range(200):
                with spans.span(name):
                    with spans.span(name + ".inner"):
                        pass
        except Exception as exc:   # noqa: BLE001 -- reported below
            errors.append(exc)
    with spans.recording():
        ts = [threading.Thread(target=work, args=(f"t{i}",))
              for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in ts)
    depth = {s.name: s.depth for s in spans.recorded()}
    assert depth == {**{f"t{i}": 0 for i in range(4)},
                     **{f"t{i}.inner": 1 for i in range(4)}}
