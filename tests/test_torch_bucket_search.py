"""Port bucket search against the JAX reference.

The plain versions (``kernels/ref.py``) and the port's layout dispatch
(``kernels/ops.py``) get the same numpy inputs as the reference's
``ops.bucket_search`` (its Pallas kernels in interpret mode on the CPU)
and ``ref.bucket_search_ref``.  Tolerance: integers (gids, hit counts,
spans) equal; distances within rtol = atol = 1e-5, the reference's own
kernel tolerance (``tests/test_kernels.py``).  Inside the port the CSR
path must be BITWISE equal to the full scan.

The CUDA kernels themselves are held against the plain versions in
``test_torch_cuda.py``, which needs no jax and skips without a card.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.types import (QueryBatch as JQuery,  # noqa: E402
                                 StoreView as JStore)
from repro_torch.core import store_layout  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.types import QueryBatch, StoreView  # noqa: E402
from test_torch_cuda import case as _case  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401
from test_torch_cuda import sorted_store_case as _sorted_store_case  # noqa
from test_torch_cuda import to_torch as _torch  # noqa: E402

F32_MAX = np.float32(np.finfo(np.float32).max)
IMAX = np.iinfo(np.int32).max
TOL = dict(rtol=1e-5, atol=1e-5)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _jax(c):
    query = JQuery(q=jnp.asarray(c["q"]), qsq=jnp.asarray(c["qsq"]),
                   buckets=jnp.asarray(c["qb"]),
                   probe=jnp.asarray(c["probe"]),
                   table=jnp.asarray(c["qtab"]))
    store = JStore(points=jnp.asarray(c["p"]), psq=jnp.asarray(c["psq"]),
                   buckets=jnp.asarray(c["pb"]), gid=jnp.asarray(c["gid"]),
                   valid=jnp.asarray(c["pvalid"]),
                   table=jnp.asarray(c["ptab"]))
    return query, store


def _lead(obj):
    """A QueryBatch/StoreView with a leading shard axis of 1."""
    return type(obj)(**{k: v[None] if torch.is_tensor(v) else v
                        for k, v in vars(obj).items()})


def _assert_same(got, want):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               **TOL)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))


@pytest.mark.parametrize("R,N,d,L", [(128, 128, 32, 4), (128, 256, 64, 8),
                                     (100, 200, 16, 2), (256, 384, 48, 16)])
def test_full_scan_matches_reference(R, N, d, L):
    c = _case(R + N, R, N, d, L)
    jq, js = _jax(c)
    want = jops.bucket_search(query=jq, store=js, cr2=2.5, L=L)
    want_ref = jref.bucket_search_ref(query=jq, store=js, cr2=2.5, L=L)
    tq, ts = _torch(c)
    got = ops.bucket_search(query=tq, store=ts, cr2=2.5, L=L)
    _assert_same(got, want)
    _assert_same(ref.bucket_search_ref(query=tq, store=ts, cr2=2.5, L=L),
                 want_ref)


@pytest.mark.parametrize("K", [1, 5, 32])
@pytest.mark.parametrize("R,N,d,L", [(128, 384, 16, 8), (256, 256, 32, 4)])
def test_topk_matches_reference(K, R, N, d, L):
    """Top-K parity with rows short of K hits (sentinel tails)."""
    c = _case(K * 7 + R, R, N, d, L, frac_match=0.5)
    jq, js = _jax(c)
    want = jops.bucket_search(query=jq, store=js, cr2=40.0, L=L, k=K)
    tq, ts = _torch(c)
    got = ops.bucket_search(query=tq, store=ts, cr2=40.0, L=L, k=K)
    assert got[0].shape == (R, K)
    _assert_same(got, want)
    short = np.asarray(want[2]) < K
    if short.any():
        i = np.nonzero(short)[0][0]
        assert got[0][i, -1] == F32_MAX and got[1][i, -1] == IMAX


def test_topk_ties_order_by_gid():
    R, N, L, K = 128, 256, 1, 5
    c = dict(q=np.zeros((R, 8), np.float32), qsq=np.zeros(R, np.float32),
             qb=np.zeros((R, 2), np.int32), probe=np.ones((R, L), np.int32),
             qtab=np.zeros(R, np.int32), p=np.ones((N, 8), np.float32),
             psq=np.full(N, 8.0, np.float32), pb=np.zeros((N, 2), np.int32),
             gid=np.arange(N, dtype=np.int32)[::-1].copy(),
             pvalid=np.ones(N, np.int32), ptab=np.zeros(N, np.int32))
    jq, js = _jax(c)
    want = jops.bucket_search(query=jq, store=js, cr2=100.0, L=L, k=K)
    tq, ts = _torch(c)
    got = ops.bucket_search(query=tq, store=ts, cr2=100.0, L=L, k=K)
    _assert_same(got, want)
    np.testing.assert_array_equal(got[1][0].numpy(), np.arange(K))
    assert np.all(got[2].numpy() == N)


@pytest.mark.parametrize("T", [2, 4])
def test_table_mask_matches_reference(T):
    R, N, d, L = 128, 256, 32, 4
    c = _case(41 + T, R, N, d, L, frac_match=0.6, T=T)
    jq, js = _jax(c)
    want = jops.bucket_search(query=jq, store=js, cr2=40.0, L=L, k=4)
    tq, ts = _torch(c)
    _assert_same(ops.bucket_search(query=tq, store=ts, cr2=40.0, L=L, k=4),
                 want)


def test_no_probes_no_hits():
    c = _case(0, 128, 128, 8, 2)
    c["probe"][:] = 0
    tq, ts = _torch(c)
    best, gid, cnt = ops.bucket_search(query=tq, store=ts, cr2=1.0, L=2,
                                       k=4)
    assert torch.all(best == F32_MAX) and torch.all(gid == IMAX)
    assert torch.all(cnt == 0)


def test_shard_axis_equals_per_shard_calls():
    """A leading shard axis answers exactly as S separate calls."""
    cs = [_case(s, 64, 96, 16, 4, frac_match=0.5) for s in range(3)]
    per = [ops.bucket_search(query=_torch(c)[0], store=_torch(c)[1],
                             cr2=40.0, L=4, k=3) for c in cs]
    stk = lambda k: torch.stack([torch.from_numpy(c[k]) for c in cs])
    query = QueryBatch(q=stk("q"), qsq=stk("qsq"), buckets=stk("qb"),
                       probe=stk("probe"), table=stk("qtab"))
    store = StoreView(points=stk("p"), psq=stk("psq"), buckets=stk("pb"),
                      gid=stk("gid"), valid=stk("pvalid"), table=stk("ptab"))
    got = ops.bucket_search(query=query, store=store, cr2=40.0, L=4, k=3)
    for s in range(3):
        np.testing.assert_array_equal(_bits(got[0][s]), _bits(per[s][0]))
        np.testing.assert_array_equal(got[1][s], per[s][1])
        np.testing.assert_array_equal(got[2][s], per[s][2])


# ---------------------------------------------------------------------------
# CSR: spans and the gather dispatch on hand-built sorted stores
# ---------------------------------------------------------------------------

def _degenerate():
    """Six rows, buckets 0/2/3 present: bucket 0 holds three live rows,
    bucket 1 is absent, bucket 2 one row, bucket 3 two tombstoned rows
    (the reference's `_degenerate_store`)."""
    d = 8
    packed = np.zeros((6, 2), np.int32)
    packed[:, 1] = [0, 0, 0, 2, 3, 3]
    table = np.zeros(6, np.int32)
    points = np.zeros((6, d), np.float32)
    points[:, 0] = np.arange(1, 7, dtype=np.float32)
    valid = np.array([1, 1, 1, 1, 0, 0], np.int32)
    gid = np.arange(10, 16, dtype=np.int32)
    bs, be = store_layout.bucket_spans(table, packed)
    qb = np.zeros((4, 2), np.int32)
    qb[:, 1] = np.arange(4)
    t = torch.from_numpy
    store = StoreView.build(t(points), t(packed), t(gid), t(valid),
                            bucket_start=t(bs), bucket_end=t(be), n_sorted=6)
    query = QueryBatch.build(torch.zeros((4, d)), t(qb),
                             torch.ones((4, 1), dtype=torch.int32))
    jstore = JStore.build(jnp.asarray(points), jnp.asarray(packed),
                          jnp.asarray(gid), jnp.asarray(valid),
                          bucket_start=jnp.asarray(bs),
                          bucket_end=jnp.asarray(be), n_sorted=6)
    jquery = JQuery.build(jnp.zeros((4, d), jnp.float32), jnp.asarray(qb),
                          jnp.ones((4, 1), jnp.int32))
    return query, store, jquery, jstore


def test_probe_spans_degenerate_buckets():
    query, store, jquery, jstore = _degenerate()
    start, end = ops.csr_probe_spans(_lead(query), _lead(store))
    np.testing.assert_array_equal(start[0, :, 0], [0, 3, 3, 4])
    np.testing.assert_array_equal(end[0, :, 0], [3, 3, 4, 6])
    js, je = jops.csr_probe_spans(jquery, jstore)
    np.testing.assert_array_equal(start[0], np.asarray(js))
    np.testing.assert_array_equal(end[0], np.asarray(je))


@pytest.mark.parametrize("cr2", [100.0, 5.0])
def test_gather_degenerate_matches_full_scan_and_reference(cr2):
    query, store, jquery, jstore = _degenerate()
    kw = dict(query=query, store=store, cr2=cr2, L=1, k=4)
    csr = ops.bucket_search(**kw)
    full = ops.bucket_search(**kw, force_full_scan=True)
    for a, b in zip(csr, full):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    want = jops.bucket_search(query=jquery, store=jstore, cr2=cr2, L=1, k=4)
    _assert_same(csr, want)


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("n_tail", [0, 37])
@pytest.mark.parametrize("window", [1, 4])
def test_csr_dispatch_bitwise_equals_full_scan(T, n_tail, window):
    """Sorted region + tail, uint32 words above 2**31 (int32-negative),
    repeated and absent probes: bitwise equal to the full scan, and equal
    to the reference's CSR dispatch on the same store, whose window of 1
    tile overflows into its full-scan fallback and of 4 does not (the
    port's gather has no window)."""
    L, K, ns = 6, 5, 300
    c = _sorted_store_case(7 * T + n_tail, ns, n_tail, 16, L, T)
    tq, ts = _torch(c)
    ts = StoreView(points=ts.points, psq=ts.psq, buckets=ts.buckets,
                   gid=ts.gid, valid=ts.valid, table=ts.table,
                   bucket_start=torch.from_numpy(c["bs"]),
                   bucket_end=torch.from_numpy(c["be"]), n_sorted=ns)
    kw = dict(query=tq, store=ts, cr2=3.0, L=L, k=K)
    csr = ops.bucket_search(**kw)
    full = ops.bucket_search(**kw, force_full_scan=True)
    for a, b in zip(csr, full):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(csr[2].sum()) > 0
    jq, js = _jax(c)
    js = JStore(points=js.points, psq=js.psq, buckets=js.buckets,
                gid=js.gid, valid=js.valid, table=js.table,
                bucket_start=jnp.asarray(c["bs"]),
                bucket_end=jnp.asarray(c["be"]), n_sorted=ns)
    _assert_same(csr, jops.bucket_search(query=jq, store=js, cr2=3.0, L=L,
                                         k=K, window_tiles=window))
    # spans: the same lower bound as the reference's uint32 search
    start, end = ops.csr_probe_spans(_lead(tq), _lead(ts))
    js_, je_ = jops.csr_probe_spans(jq, js)
    np.testing.assert_array_equal(start[0], np.asarray(js_))
    np.testing.assert_array_equal(end[0], np.asarray(je_))


def test_gather_plain_version_walks_only_the_span():
    """The gather's plain version counts exactly the valid points inside
    each row's span, nearest first."""
    rng = np.random.default_rng(5)
    N, d, K = 512, 8, 3
    p = torch.from_numpy(rng.standard_normal((1, N, d)).astype(np.float32))
    psq = (p * p).sum(-1)
    q = torch.zeros((1, 4, d))
    start = torch.tensor([[0, 100, 300, 7]], dtype=torch.int32)
    end = torch.tensor([[0, 228, 301, 7]], dtype=torch.int32)
    gid = torch.arange(N, dtype=torch.int32)[None]
    valid = torch.ones((1, N), dtype=torch.int32)
    valid[0, 150] = 0
    td, tg, cnt = ref.bucket_gather_ref(q, torch.zeros((1, 4)), start, end,
                                        p, psq, gid, valid, 1e9, K=K)
    assert cnt.tolist() == [[0, 127, 1, 0]]
    inside = [c for c in range(100, 228) if c != 150]
    nearest = sorted(inside, key=lambda c: (float(psq[0, c]), c))[:K]
    assert tg[0, 1].tolist() == nearest and tg[0, 2, 0] == 300
    assert torch.all(tg[0, 0] == IMAX) and torch.all(td[0, 3] == F32_MAX)
