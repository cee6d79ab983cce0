"""The port's staged query, query pipeline and async service.

  * ``query_staged`` (dispatch / scan / return) is BITWISE ``query()``,
    with 1, 0 and 1 counted exchanges for the three stages, for T in
    {1, 2}, before and after an insert;
  * an interleaved insert/delete/query stream through
    ``AsyncLSHService`` (pipeline depth 2, batches in flight) answers
    bitwise as the port's ``ShardedLSHService`` on the same stream;
  * the same stream answers as the reference's ``AsyncLSHService`` at
    the same bucket size (one reference subprocess at S = 8, the
    reference's parameters carried across): gids and fq EQUAL, distances
    within rtol = atol = 1e-5;
  * the cases of ``tests/test_serving_pipeline.py``: deadline flushes on
    the injected clock, reject and block admission, at most one
    background snapshot in flight, a poisoned item fails only its own
    handle, and a crash with a batch in flight recovers to the
    synchronous store of every write whose append returned.
"""
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from repro_torch import convert, persist
from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme
from repro_torch.serving import (AdmissionFull, AsyncLSHService,
                                 QueryPipeline, ShardedLSHService)
from test_torch_cuda import one_torch_thread  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
N, M, D = 768, 64, 32


def make_cfg(S=8, T=1):
    return LSHConfig(d=D, k=8, W=1.2, r=0.3, c=2.0, L=8, n_shards=S,
                     scheme=Scheme.LAYERED, seed=0, n_tables=T)


def _data():
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((N, D)) / np.sqrt(D)).astype(np.float32)
    q = data[rng.integers(0, N, M)] + rng.standard_normal((M, D)).astype(
        np.float32) * np.float32(0.3 / np.sqrt(D))
    return data, q.astype(np.float32)


DATA, QUERIES = _data()


def assert_same_result(a, b):
    np.testing.assert_array_equal(a.topk_gid, b.topk_gid)
    np.testing.assert_array_equal(a.topk_dist.view(np.uint32),
                                  b.topk_dist.view(np.uint32))
    np.testing.assert_array_equal(a.n_within_cr, b.n_within_cr)
    np.testing.assert_array_equal(a.fq, b.fq)
    np.testing.assert_array_equal(a.query_load, b.query_load)
    assert a.drops == b.drops


def _index(T, params=None, keys=None):
    idx = DistributedLSHIndex(make_cfg(T=T), device="cpu", k_neighbors=5)
    if params is not None:
        convert.install(idx, params, keys)
    idx.init_store(idx._store_capacity(4 * N * T))
    return idx


@pytest.mark.parametrize("T", [1, 2])
def test_staged_query_bitwise_equals_fused(T):
    idx = _index(T)
    idx.insert(DATA[:512])
    calls = idx.a2a.calls
    disp = idx.query_dispatch(QUERIES)
    assert idx.a2a.calls == calls + 1
    scanned = idx.query_scan(disp)
    assert idx.a2a.calls == calls + 1
    idx.query_return(scanned)
    assert idx.a2a.calls == calls + 2
    assert_same_result(idx.query_staged(QUERIES), idx.query(QUERIES))
    idx.compact()
    idx.insert(DATA[512:640])       # sorted region + tail
    assert_same_result(idx.query_staged(QUERIES, k_neighbors=3),
                       idx.query(QUERIES, k_neighbors=3))
    with pytest.raises(ValueError, match="divide"):
        idx.query_dispatch(QUERIES[:5])
    with pytest.raises(ValueError, match="k_neighbors"):
        idx.query_scan(disp, k_neighbors=0)


def test_single_table_views():
    """``params`` is table 0 of the stacked parameters and ``base_key``
    the root the stacked offset keys derive from (what a snapshot saves
    besides the stacks)."""
    from repro_torch.core.offsets import stacked_base_keys
    idx = _index(2)
    for f in ("A", "b", "pack_mult"):
        np.testing.assert_array_equal(getattr(idx.params, f).numpy(),
                                      getattr(idx.stacked_params, f)[0])
    np.testing.assert_array_equal(stacked_base_keys(idx.base_key, 2),
                                  idx.stacked_keys)


def drive(svc):
    """One admitted stream (the reference test's); returns per-query
    (gids, dists, fq)."""
    rng = np.random.default_rng(7)
    handles = []
    svc.insert(DATA[:256])
    for step in range(4):
        qs = QUERIES[rng.permutation(64)[:48]]
        handles += svc.submit_batch(qs)           # 48 = 1.5 buckets
        lo = 256 + step * 64
        svc.insert(DATA[lo:lo + 64])
        svc.delete(np.arange(step, 256 + step * 64, 17))
        handles += svc.submit_batch(QUERIES[:32])
    svc.drain()
    assert all(h.done for h in handles)
    return (np.stack([h.gids for h in handles]),
            np.stack([h.dists for h in handles]),
            np.asarray([h.fq for h in handles]))


@pytest.mark.parametrize("T", [1, 2])
def test_async_stream_bitwise_equals_sync(T):
    sync = ShardedLSHService(_index(T), bucket_size=32,
                             max_latency_ms=float("inf"), k_neighbors=5)
    g0, d0, f0 = drive(sync)
    with AsyncLSHService(_index(T), bucket_size=32,
                         max_latency_ms=float("inf"), k_neighbors=5,
                         pipeline_depth=2) as asvc:
        g1, d1, f1 = drive(asvc)
        assert asvc.stats.inflight_peak >= 1
    np.testing.assert_array_equal(g0, g1)
    np.testing.assert_array_equal(d0.view(np.uint32), d1.view(np.uint32))
    np.testing.assert_array_equal(f0, f1)
    assert sync.stats.queries == asvc.stats.queries == 320
    assert "inflight_peak=" in asvc.stats.summary()


def test_pipeline_keeps_depth_batches_in_flight():
    """Submitted batches stay in flight until retired, at most depth of
    them; answers are those of the index, bucket by bucket."""
    idx = _index(2)
    idx.insert(DATA[:512])
    pipe = QueryPipeline(idx, 16, depth=2)
    handles = [[type("H", (), {"t_submit": 0.0})() for _ in range(16)]
               for _ in range(4)]
    for b in range(3):
        pipe.submit(list(QUERIES[16 * b:16 * b + 16]), handles[b])
        assert pipe.n_inflight == min(b + 1, 2)
    pipe.submit(list(QUERIES[48:60]), handles[3][:12], reason="deadline")
    assert pipe.stats.inflight_peak == 2 and pipe.drain() == 28
    for b in range(4):
        buf = np.zeros((16, D), np.float32)
        take = 16 if b < 3 else 12
        buf[:take] = QUERIES[16 * b:16 * b + take]
        want = idx.query(buf)
        for i in range(take):
            np.testing.assert_array_equal(handles[b][i].gids,
                                          want.topk_gid[i])
            np.testing.assert_array_equal(handles[b][i].dists,
                                          want.topk_dist[i])
    assert pipe.stats.flush_deadline == 1 and pipe.stats.pad_rows == 4
    with pytest.raises(ValueError, match="depth"):
        QueryPipeline(idx, 16, depth=0)


_SCRIPT = """
import sys
import numpy as np
from repro.compat import make_mesh
from repro.core import DistributedLSHIndex, LSHConfig, Scheme
from repro.serving import AsyncLSHService

out_dir = sys.argv[1]
z = np.load(out_dir + "/inputs.npz")
data, queries = z["data"], z["queries"]
mesh = make_mesh((8,), ("shard",))
cfg = LSHConfig(d=data.shape[1], k=8, W=1.2, r=0.3, c=2.0, L=8,
                n_shards=8, scheme=Scheme.LAYERED, seed=0, n_tables=2)
idx = DistributedLSHIndex(cfg, mesh, k_neighbors=5)
idx.init_store(idx._store_capacity(4 * len(data) * 2))
out = {f"param_{f}": np.asarray(getattr(idx.stacked_params, f))
       for f in ("A", "b", "alpha", "beta", "alpha_cauchy", "pack_mult",
                 "pack_add")}
out["keys"] = np.asarray(idx.stacked_keys)
rng = np.random.default_rng(7)
handles = []
with AsyncLSHService(idx, bucket_size=32, max_latency_ms=float("inf"),
                     k_neighbors=5, pipeline_depth=2) as svc:
    svc.insert(data[:256])
    for step in range(4):
        handles += svc.submit_batch(queries[rng.permutation(64)[:48]])
        lo = 256 + step * 64
        svc.insert(data[lo:lo + 64])
        svc.delete(np.arange(step, 256 + step * 64, 17))
        handles += svc.submit_batch(queries[:32])
    svc.drain()
out["gids"] = np.stack([h.gids for h in handles])
out["dists"] = np.stack([h.dists for h in handles])
out["fq"] = np.asarray([h.fq for h in handles])
np.savez(out_dir + "/ref.npz", **out)
print("OK")
"""


def test_async_stream_equals_the_reference_async_service(tmp_path):
    np.savez(tmp_path / "inputs.npz", data=DATA, queries=QUERIES)
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false")
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_SCRIPT),
                           str(tmp_path)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ref = np.load(tmp_path / "ref.npz")
    idx = _index(2, {f: ref["param_" + f] for f in convert.FIELDS},
                 ref["keys"])
    with AsyncLSHService(idx, bucket_size=32, max_latency_ms=float("inf"),
                         k_neighbors=5, pipeline_depth=2) as svc:
        g, d, f = drive(svc)
    np.testing.assert_array_equal(g, ref["gids"])
    np.testing.assert_allclose(d, ref["dists"], **TOL)
    np.testing.assert_array_equal(f, ref["fq"])
    assert (g[:, 0] != np.iinfo(np.int32).max).mean() > 0.25


# ---------------------------------------------------------------------
# Single-shard cases (the reference test's in-process ones)
# ---------------------------------------------------------------------

def _small_index(T: int = 1, k_neighbors: int = 4):
    cfg = LSHConfig(d=8, k=4, W=1.2, r=0.3, c=2.0, L=4, n_shards=1,
                    scheme=Scheme.LAYERED, seed=0, n_tables=T)
    idx = DistributedLSHIndex(cfg, device="cpu", k_neighbors=k_neighbors)
    idx.init_store(idx._store_capacity(8 * 256 * T))
    return idx


def _small_data(n=96, m=24, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, 8)).astype(np.float32)
    queries = data[:m] + rng.normal(scale=0.05, size=(m, 8)).astype(
        np.float32)
    return data, queries


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_deadline_flush_uses_injected_clock():
    """A partial bucket flushes when the INJECTED clock passes the
    deadline -- wall time never does."""
    data, queries = _small_data()
    clock = FakeClock()
    with AsyncLSHService(_small_index(), bucket_size=8,
                         max_latency_ms=25.0, k_neighbors=4,
                         clock=clock) as svc:
        svc.insert(data[:48]).result(timeout=30)
        h = svc.submit(queries[0])
        time.sleep(0.2)           # real time passes; injected does not
        assert not h.done and svc.stats.flush_deadline == 0
        clock.t += 0.1            # 100ms > the 25ms SLO
        deadline = time.monotonic() + 30
        while not h.done and time.monotonic() < deadline:
            time.sleep(0.005)
        assert h.done and h.gids is not None
        assert svc.stats.flush_deadline == 1
        assert svc.stats.flush_manual == 0


def test_reject_admission_backpressure():
    data, queries = _small_data()
    svc = AsyncLSHService(_small_index(), bucket_size=8,
                          max_latency_ms=float("inf"), k_neighbors=4,
                          queue_depth=2, admission="reject",
                          autostart=False)
    with pytest.raises(RuntimeError, match="engine not running"):
        svc.drain()
    svc.submit_batch(queries[:2])
    svc.insert(data[:8])
    with pytest.raises(AdmissionFull):
        svc.submit_batch(queries[2:4])
    assert svc.stats.rejects == 1
    assert svc.stats.queue_peak == 2
    svc.start()
    svc.drain()
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(queries[0])
    with pytest.raises(ValueError, match="admission"):
        AsyncLSHService(_small_index(), admission="drop")


def test_block_admission_backpressure():
    """admission='block' parks the producer on a full queue until the
    engine drains it -- no rejects, no loss."""
    _, queries = _small_data()
    svc = AsyncLSHService(_small_index(), bucket_size=4,
                          max_latency_ms=float("inf"), k_neighbors=4,
                          queue_depth=1, admission="block",
                          autostart=False)
    svc.submit_batch(queries[:4])           # fills the queue
    handles = []
    blocked = threading.Thread(
        target=lambda: handles.extend(svc.submit_batch(queries[4:8])))
    blocked.start()
    blocked.join(timeout=0.3)
    assert blocked.is_alive()               # parked on the full queue
    svc.start()                             # engine drains -> unblocks
    blocked.join(timeout=30)
    assert not blocked.is_alive()
    svc.drain()
    assert all(h.done for h in handles)
    assert svc.stats.rejects == 0 and svc.stats.queries == 8
    svc.close()


def test_background_snapshot_at_most_one_in_flight(tmp_path,
                                                   monkeypatch):
    """While one background snapshot writes, further requests are
    skipped (counted); the written snapshot recovers with nothing to
    replay."""
    import importlib
    snapmod = importlib.import_module("repro_torch.persist.snapshot")
    gate = threading.Event()
    real_write = snapmod._write_state
    writer_threads = []

    def slow_write(state, snap_dir, **kw):
        writer_threads.append(threading.current_thread().name)
        # the writer gets host copies only
        assert isinstance(state["rows"]["x"], np.ndarray)
        assert gate.wait(timeout=30)
        return real_write(state, snap_dir, **kw)

    data, _ = _small_data()
    snap = str(tmp_path / "snap")
    monkeypatch.setattr(snapmod, "_write_state", slow_write)
    with AsyncLSHService(_small_index(), bucket_size=8,
                         max_latency_ms=float("inf"),
                         k_neighbors=4) as svc:
        svc.wal = persist.WriteAheadLog(persist.wal_path(snap))
        svc.insert(data[:48]).result(timeout=30)
        path = svc.snapshot(snap).result(timeout=30)
        assert path is not None
        assert svc.snapshot(snap).result(timeout=30) is None
        assert svc.stats.snapshots == 1
        assert svc.stats.snapshots_skipped == 1
        gate.set()
    assert writer_threads == ["lsh-snapshot-writer"]
    assert os.path.isdir(path) and persist.has_snapshot(snap)
    rr = persist.recover(snap, device="cpu",
                         capacity=_small_index().store.capacity,
                         k_neighbors=4)
    assert rr.replayed_inserts == 0 and rr.index.n_live == 48
    rr.wal.close()


def test_engine_survives_poisoned_item():
    """A failing item resolves its own waiters with the error; the
    engine keeps serving subsequent work."""
    data, queries = _small_data()
    with AsyncLSHService(_small_index(), bucket_size=8,
                         max_latency_ms=float("inf"),
                         k_neighbors=4) as svc:
        svc.insert(data[:48]).result(timeout=30)
        bad = svc.insert(np.ones((4, 3), np.float32))   # wrong d
        with pytest.raises(Exception):
            bad.result(timeout=30)
        h = svc.submit_batch(queries[:8])
        svc.drain()
        assert all(x.done for x in h)
        with pytest.raises(ValueError, match="queries must be"):
            svc.submit_batch(np.ones((2, 3), np.float32))


def test_crash_with_batch_in_flight_recovers(tmp_path):
    """Abandon the service (no drain, no close) with a batch in flight
    and a partial bucket parked; WAL replay converges bitwise to the
    synchronous store of every write whose append returned."""
    CAP = 4 * N * 2
    tmp = str(tmp_path)
    idx = DistributedLSHIndex(make_cfg(T=2), device="cpu", k_neighbors=5)
    idx.init_store(CAP)
    wal = persist.WriteAheadLog(persist.wal_path(tmp), group_commit_n=4)
    svc = AsyncLSHService(idx, bucket_size=32, max_latency_ms=float("inf"),
                          k_neighbors=5, wal=wal)
    persist.snapshot(idx, tmp, wal=wal)           # boot snapshot
    svc.insert(DATA[:256]).result(timeout=60)
    svc.submit_batch(QUERIES[:48])                # 1 bucket in flight
    svc.insert(DATA[256:384]).result(timeout=60)
    svc.delete(np.arange(0, 256, 13)).result(timeout=60)
    svc.submit_batch(QUERIES[:16])                # parked partial
    wal.close()                                   # CRASH

    rr = persist.recover(tmp, device="cpu", capacity=CAP, k_neighbors=5)
    assert rr.replayed_inserts == 2 and rr.replayed_deletes == 1
    ref = DistributedLSHIndex(make_cfg(T=2), device="cpu", k_neighbors=5)
    ref.init_store(CAP)
    ref.insert(DATA[:256], gids=np.arange(256))
    ref.insert(DATA[256:384], gids=np.arange(256, 384))
    ref.delete(np.arange(0, 256, 13))
    assert_same_result(rr.index.query(QUERIES), ref.query(QUERIES))
    assert rr.index._next_gid == ref._next_gid == 384
    rr.wal.close()


def test_drain_raises_when_the_engine_died(monkeypatch):
    """A waiter never blocks forever on an engine thread that stopped:
    not in drain(), not in a handle's result(), not on a full queue."""
    data, queries = _small_data()
    svc = AsyncLSHService(_small_index(), bucket_size=8,
                          max_latency_ms=float("inf"), queue_depth=2,
                          autostart=False)
    started = threading.Event()

    def dies():
        started.set()
        raise RuntimeError("engine start failed")
    monkeypatch.setattr(svc, "_engine_loop", dies)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    svc.start()
    assert started.wait(30)
    svc._engine.join(30)
    with pytest.raises(RuntimeError, match="engine"):
        svc.drain()
    h = svc.submit(queries[0])
    with pytest.raises(RuntimeError, match="engine"):
        h.result()                       # its flush fills the queue
    with pytest.raises(RuntimeError, match="engine"):
        svc.insert(data[:8])             # blocking put on a full queue
    svc._q.get_nowait()
    w = svc.insert(data[:8])
    with pytest.raises(RuntimeError, match="engine"):
        w.result(timeout=30)
