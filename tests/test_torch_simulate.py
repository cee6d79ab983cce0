"""The port's analytic simulator against the JAX reference, on the CPU.

The same seeded numpy data (n = 4,096 planted points, m = 256 queries,
d = 50) go through ``repro.core.simulate`` and, with the reference's
sampled parameters and offset keys carried across (``convert.py``, and
``make_sim`` patched to give them),
through ``repro_torch.core.simulate`` with ``device="cpu"``, at L = 16
on 8 shards, for every Scheme, T in {1, 2} and entropy and mplsh probes.
Tolerance: every integer field of ``TrafficReport``/``StreamReport``
EQUAL (rows, bytes, loads, f_q max, per-table tuples, emitted), the
float fields within 1e-6, recall and recall@10 EQUAL, the summaries
alike; ``lsh_topk_reference`` gids equal and distances within rtol =
atol = 1e-5.  Inside the port: the CPU index answers as its own
``lsh_topk_reference`` and ends a stream with ``simulate_stream``'s
loads.
"""
import dataclasses
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401
import repro_torch.core  # noqa: E402,F401
from repro.core import accounting as jacc, config as jconfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import accounting as tacc, config as tconfig  # noqa
from repro_torch.core import DistributedLSHIndex  # noqa: E402
from repro_torch.serving import ShardedLSHService  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

jsim = sys.modules["repro.core.simulate"]
tsim = sys.modules["repro_torch.core.simulate"]

N, M, D = 4096, 256, 50
TOL = dict(rtol=1e-5, atol=1e-5)
SCHEMES = ["simple", "layered", "sum", "cauchy"]


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((N, D)) / np.sqrt(D)).astype(np.float32)
    queries = (data[rng.integers(0, N, M)]
               + rng.standard_normal((M, D)).astype(np.float32)
               * np.float32(0.3 / np.sqrt(D))).astype(np.float32)
    return data, queries


def _cfgs(scheme, T, probes="entropy"):
    kw = dict(d=D, k=10, W=1.2, r=0.3, c=2.0, L=16, n_shards=8, seed=0,
              n_tables=T, probes=probes)
    return (jconfig.LSHConfig(scheme=jconfig.Scheme(scheme), **kw),
            tconfig.LSHConfig(scheme=tconfig.Scheme(scheme), **kw))


def _carry(monkeypatch, jcfg, tcfg):
    """The port's simulator samples the reference's parameters and offset
    keys for tcfg from now on (as ``convert.install`` puts them into an
    index)."""
    js = jsim.make_sim(jcfg)
    sim = tsim.SimState(
        tcfg, convert.stacked_params_from_arrays(
            {f: np.asarray(getattr(js.stacked_params, f))
             for f in convert.FIELDS}),
        convert.keys_from_array(np.asarray(js.stacked_keys)))
    monkeypatch.setattr(tsim, "make_sim",
                        lambda cfg, device=None:
                        sim.to(tsim.resolve_device(device)))


def _assert_reports_equal(want, got):
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, float) and f.name not in ("recall", "recall_at_k"):
            assert abs(a - b) <= 1e-6, (f.name, a, b)
        elif isinstance(a, np.ndarray):
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-6,
                                           err_msg=f.name)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)
    assert want.summary() == got.summary()


@pytest.mark.parametrize("probes", ["entropy", "mplsh"])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_simulate_matches_reference(monkeypatch, dataset, scheme, T, probes):
    data, queries = dataset
    jcfg, tcfg = _cfgs(scheme, T, probes)
    _carry(monkeypatch, jcfg, tcfg)
    want = jsim.simulate(jcfg, jnp.asarray(data), jnp.asarray(queries),
                         compute_recall=True, k_neighbors=10)
    got = tsim.simulate(tcfg, data, queries, compute_recall=True,
                        k_neighbors=10, device="cpu")
    assert isinstance(got, tacc.TrafficReport)
    _assert_reports_equal(want, got)
    assert got.query_rows > 0 and 0 < got.recall <= 1
    assert got.overflow_drops == 0


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_simulate_stream_matches_reference(monkeypatch, dataset, scheme, T):
    data, queries = dataset
    jcfg, tcfg = _cfgs(scheme, T)
    _carry(monkeypatch, jcfg, tcfg)
    kw = dict(n_prefix=1024, insert_batch=1024, query_batch=64)
    want = jsim.simulate_stream(jcfg, jnp.asarray(data),
                                jnp.asarray(queries), **kw)
    got = tsim.simulate_stream(tcfg, data, queries, device="cpu", **kw)
    assert got.steps == 3 and got.total_queries == 3 * 64
    _assert_reports_equal(want, got)


@pytest.mark.parametrize("probes", ["entropy", "mplsh"])
@pytest.mark.parametrize("T", [1, 2])
def test_lsh_topk_reference_matches_reference(monkeypatch, dataset, T,
                                              probes):
    data, queries = dataset
    jcfg, tcfg = _cfgs("layered", T, probes)
    _carry(monkeypatch, jcfg, tcfg)
    wd, wg = jsim.lsh_topk_reference(jcfg, jnp.asarray(data),
                                     jnp.asarray(queries), 10)
    gd, gg = tsim.lsh_topk_reference(tcfg, data, queries, 10, device="cpu")
    np.testing.assert_array_equal(gg, wg)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], **TOL)
    assert fin[:, 0].mean() > 0.25


@pytest.mark.parametrize("T", [1, 2])
def test_port_index_answers_as_its_lsh_topk_reference(dataset, T):
    """The port's index on the CPU, its own sampled parameters, against
    the port's single-machine oracle with the same derivation."""
    data, queries = dataset
    _, cfg = _cfgs("layered", T)
    idx = DistributedLSHIndex(cfg, device="cpu", k_neighbors=10)
    idx.build(data)
    qr = idx.query(queries)
    refd, refg = tsim.lsh_topk_reference(cfg, data, queries, 10,
                                         device="cpu")
    np.testing.assert_array_equal(qr.topk_gid, refg)
    fin = np.isfinite(qr.topk_dist)
    np.testing.assert_array_equal(fin, np.isfinite(refd))
    np.testing.assert_allclose(qr.topk_dist[fin], refd[fin], rtol=1e-4,
                               atol=1e-5)
    # n_within_cr counts (point, table) hits: with T = 2 a point found
    # in both tables counts twice, as the simulator's emitted total does
    assert np.all(fin.sum(1) <= np.minimum(10, qr.n_within_cr))
    rep = tsim.simulate(cfg, data, queries, compute_recall=True,
                        device="cpu")
    assert int(qr.n_within_cr.sum()) == rep.results_emitted


def test_simulate_stream_matches_port_index_loads(dataset):
    """The analytic stream against the port's index and service: final
    per-shard loads equal, rows per query alike."""
    data, queries = dataset
    _, cfg = _cfgs("layered", 1)
    data, queries = data[:2048], queries
    rep = tsim.simulate_stream(cfg, data, queries, n_prefix=1024,
                               insert_batch=512, query_batch=64,
                               device="cpu")
    idx = DistributedLSHIndex(cfg, device="cpu")
    idx.build(data[:1024], capacity=idx._store_capacity(2048))
    svc = ShardedLSHService(idx, bucket_size=64)
    for t in range(rep.steps):
        svc.insert(data[1024 + t * 512: 1024 + (t + 1) * 512])
        sel = (np.arange(64) + t * 64) % len(queries)
        svc.submit_batch(queries[sel])
        svc.drain()
    assert svc.stats.drops == 0 and rep.steps == 2
    np.testing.assert_array_equal(rep.data_load_final, svc.shard_load())
    assert abs(rep.fq_mean - svc.stats.routed_rows / svc.stats.queries) \
        < 1e-6


def test_recall_at_k_matches_reference():
    rng = np.random.default_rng(3)
    truth = rng.integers(0, 50, (40, 10)).astype(np.int32)
    truth[::7, -3:] = np.iinfo(np.int32).max
    got = rng.integers(0, 50, (40, 10)).astype(np.int32)
    assert tsim.recall_at_k(got, truth) == jsim.recall_at_k(got, truth)


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("d", [1, 64, 3072])
def test_accounting_matches_reference(d, T):
    assert tacc.query_row_bytes(d, T) == jacc.query_row_bytes(d, T)
    assert tacc.data_row_bytes(d, T) == jacc.data_row_bytes(d, T)
    loads = np.arange(d * T) % 7
    assert tacc.load_stats(loads) == jacc.load_stats(loads)
    assert (tacc.COLLECTIVES_PER_INSERT, tacc.COLLECTIVES_PER_QUERY) == (
        jacc.COLLECTIVES_PER_INSERT, jacc.COLLECTIVES_PER_QUERY)
    kw = dict(scheme="layered", n_shards=8, query_rows=5, query_bytes=9,
              fq_mean=1.5, fq_max=3, fq_bound=2.25, data_rows=7,
              data_bytes=11, data_load_avg=0.5, data_load_max=2,
              query_load_avg=0.25, query_load_max=1, capacity_rows=4,
              capacity_bytes=8, recall=0.5, results_emitted=3,
              recall_at_k=0.125, k_neighbors=10, n_tables=T,
              query_rows_by_table=(5,) * T, data_rows_by_table=(7,) * T)
    assert (tacc.TrafficReport(**kw).summary()
            == jacc.TrafficReport(**kw).summary())
