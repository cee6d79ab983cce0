"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device (a CUDA kernel has no CPU mode) and no
jax, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Without a card they skip.  Tolerance: integers (gids, hit counts) equal;
distances within rtol = atol = 1e-5 (the kernels sum each dot with fused
multiply-adds, the plain versions with separate multiplies and adds).
The CSR gather must be BITWISE equal to the full-scan kernel.  The case
builders here are shared with ``test_torch_bucket_search.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import store_layout
from repro_torch.kernels import bucket_search as kbs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.types import QueryBatch, StoreView

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: the suite runs in parallel
    workers, and torch's default of one thread per core oversubscribes
    the machine for everyone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case(seed, R, N, d, L, frac_match=0.2, T=1):
    """The reference's `_bucket_case` shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((R, d)).astype(np.float32)
    p = rng.standard_normal((N, d)).astype(np.float32)
    return dict(
        q=q, qsq=(q * q).sum(-1).astype(np.float32),
        qb=rng.integers(0, 16, (R, 2 * L)).astype(np.int32),
        probe=(rng.random((R, L)) < frac_match).astype(np.int32),
        qtab=rng.integers(0, T, (R,)).astype(np.int32),
        p=p, psq=(p * p).sum(-1).astype(np.float32),
        pb=rng.integers(0, 16, (N, 2)).astype(np.int32),
        gid=(np.arange(N, dtype=np.int32) * 3 + 1),
        pvalid=(rng.random(N) < 0.9).astype(np.int32),
        ptab=rng.integers(0, T, (N,)).astype(np.int32))


def sorted_store_case(seed, n_sorted, n_tail, d, L, T, n_buckets=24):
    """A random store with a sorted CSR region (uint32 words above 2**31
    included) and an unsorted tail, plus queries whose probes hit, miss
    and repeat buckets."""
    rng = np.random.default_rng(seed)
    N = n_sorted + n_tail
    points = (rng.standard_normal((N, d)) * 0.3).astype(np.float32)
    packed = np.zeros((N, 2), np.uint32)
    packed[:, 0] = rng.integers(0, 3, N) * np.uint32(0x9E3779B9)
    packed[:, 1] = rng.integers(0, n_buckets, N)
    table = rng.integers(0, T, N).astype(np.int32)
    order = store_layout.sort_order(table[:n_sorted], packed[:n_sorted])
    for a in (points, packed, table):
        a[:n_sorted] = a[:n_sorted][order]
    bs = np.zeros(N, np.int32)
    be = np.zeros(N, np.int32)
    bs[:n_sorted], be[:n_sorted] = store_layout.bucket_spans(
        table[:n_sorted], packed[:n_sorted])
    gid = rng.permutation(N).astype(np.int32)
    valid = (rng.random(N) < 0.85).astype(np.int32)
    R = 40
    q = (rng.standard_normal((R, d)) * 0.3).astype(np.float32)
    qb = np.zeros((R, L, 2), np.uint32)
    pick = rng.integers(0, N, (R, L))
    qb[:] = packed[pick]
    qb[:, 1::3] = qb[:, 0:1]                     # repeated probes
    qb[:, 2::5, 1] = n_buckets + 7               # absent buckets
    probe = (rng.random((R, L)) < 0.7).astype(np.int32)
    return dict(q=q, qsq=(q * q).sum(-1).astype(np.float32),
                qb=qb.view(np.int32).reshape(R, 2 * L), probe=probe,
                qtab=table[pick[:, 0]], p=points,
                psq=(points * points).sum(-1).astype(np.float32),
                pb=packed.view(np.int32), gid=gid, pvalid=valid, ptab=table,
                bs=bs, be=be)


def to_torch(c, n_sorted=0):
    t = lambda k: torch.from_numpy(np.array(c[k]))
    query = QueryBatch(q=t("q"), qsq=t("qsq"), buckets=t("qb"),
                       probe=t("probe"), table=t("qtab"))
    csr = dict(bucket_start=t("bs"), bucket_end=t("be"),
               n_sorted=n_sorted) if n_sorted else {}
    store = StoreView(points=t("p"), psq=t("psq"), buckets=t("pb"),
                      gid=t("gid"), valid=t("pvalid"), table=t("ptab"),
                      **csr)
    return query, store


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _to(dev, obj, lead=False):
    """Move a QueryBatch/StoreView to dev (adding a shard axis if asked)."""
    f = lambda v: (v[None] if lead else v).to(dev) if torch.is_tensor(v) \
        else v
    return type(obj)(**{k: f(v) for k, v in obj.__dict__.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 5, 32, 128])
@pytest.mark.parametrize("d", [16, 48, 64, 100])
def test_full_scan_kernel_matches_plain_version(K, d):
    dev = _cuda()
    query, store = to_torch(case(K + d, 300, 70_000, d, 8, frac_match=0.5,
                                 T=2))
    want = ref.bucket_search_ref(query=_to("cpu", query, True),
                                 store=_to("cpu", store, True), cr2=2.0 * d,
                                 L=8, K=K)
    before = kbs.bucket_search_cuda.launches
    got = kbs.bucket_search_cuda(query=_to(dev, query, True),
                                 store=_to(dev, store, True), cr2=2.0 * d,
                                 L=8, K=K)
    torch.cuda.synchronize()
    assert kbs.bucket_search_cuda.launches == before + 1
    np.testing.assert_allclose(got[0].cpu(), want[0], **TOL)
    np.testing.assert_array_equal(got[1].cpu(), want[1])
    np.testing.assert_array_equal(got[2].cpu(), want[2])
    assert int(want[2].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n_tail", [0, 37, 5000])
@pytest.mark.parametrize("T", [1, 2])
def test_csr_kernels_bitwise_equal_full_scan_kernel(n_tail, T):
    dev = _cuda()
    L, K, ns = 6, 5, 3000
    c = sorted_store_case(n_tail + T, ns, n_tail, 16, L, T)
    query, store = to_torch(c, n_sorted=ns)
    plain = ops.bucket_search(query=query, store=store, cr2=3.0, L=L, k=K)
    query, store = _to(dev, query), _to(dev, store)
    before = kbs.bucket_gather_cuda.launches
    csr = ops.bucket_search(query=query, store=store, cr2=3.0, L=L, k=K)
    full = ops.bucket_search(query=query, store=store, cr2=3.0, L=L, k=K,
                             force_full_scan=True)
    torch.cuda.synchronize()
    assert kbs.bucket_gather_cuda.launches == before + 1
    for a, b in zip(csr, full):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(csr[0].cpu(), plain[0], **TOL)
    np.testing.assert_array_equal(csr[1].cpu(), plain[1])
    np.testing.assert_array_equal(csr[2].cpu(), plain[2])
    assert int(plain[2].sum()) > 0


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs():
    dev = _cuda()
    query, store = to_torch(case(0, 8, 64, 16, 2))
    query, store = _to(dev, query, True), _to(dev, store, True)
    bad = StoreView(**{**store.__dict__,
                       "psq": store.psq.to(torch.float64)})
    with pytest.raises(ValueError):
        kbs.bucket_search_cuda(query=query, store=bad, cr2=1.0, L=2, K=1)
    with pytest.raises(ValueError):
        kbs.bucket_search_cuda(query=query, store=store, cr2=1.0, L=2,
                               K=129)


@pytest.mark.gpu
@pytest.mark.parametrize("T,K", [(1, 1), (2, 5)])
def test_index_on_the_card_answers_as_on_the_cpu(T, K):
    """The whole index on the card (kernels) against the index on the
    CPU (plain versions): hashing is bitwise the same on both, so every
    integer is equal and distances agree within tolerance; the CSR path
    on the card is bitwise equal to the full scan."""
    dev = _cuda()
    from repro_torch.core import DistributedLSHIndex, LSHConfig
    cfg = LSHConfig(d=32, k=8, W=1.2, r=0.3, c=2.0, L=8, n_shards=8,
                    n_tables=T)
    rng = np.random.default_rng(T)
    data = (rng.standard_normal((4096, 32)) / np.sqrt(32)).astype(
        np.float32)
    qs = data[rng.integers(0, 4096, 64)] + (
        rng.standard_normal((64, 32)) * 0.05).astype(np.float32)
    out = {}
    for name in ("cpu", dev):
        idx = DistributedLSHIndex(cfg, device=name, k_neighbors=K)
        idx.build(data[:3000])
        a = idx.query(qs)
        idx.compact()
        idx.insert(data[3000:])
        b = idx.query(qs)
        idx.use_csr = False
        c = idx.query(qs)
        out[str(name)] = (a, b, c)
        if name != "cpu":
            for f in ("topk_gid", "n_within_cr", "fq"):
                np.testing.assert_array_equal(getattr(b, f), getattr(c, f))
            np.testing.assert_array_equal(b.topk_dist.view(np.uint32),
                                          c.topk_dist.view(np.uint32))
    for got, want in zip(out[str(dev)], out["cpu"]):
        for f in ("topk_gid", "n_within_cr", "fq", "query_load"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_allclose(got.topk_dist, want.topk_dist, **TOL)
