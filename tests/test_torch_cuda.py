"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device (a CUDA kernel has no CPU mode) and no
jax, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Without a card they skip.  Tolerances: bucket search -- integers (gids,
hit counts) equal, distances within rtol = atol = 1e-5 (the kernels sum
each dot with fused multiply-adds, the plain versions with separate
multiplies and adds), and the CSR gather BITWISE equal to the full-scan
kernel at every width; flash attention -- rtol = atol = 2e-5 in float32
(the reference's own kernel tolerance, ``tests/test_kernels.py``) and
0.05 in bf16 (an output rounded to bf16 may land one bf16 step apart),
its lse 1e-4, and its gradient within 1e-4 (float32) or 1e-2 (bf16) of
each output's largest magnitude;
the SSD scan -- the chunked kernel against the sequential plain version
at rtol = atol = 2e-4 in float32 (the reference's chunked-vs-sequential
tolerance) and 0.05 in bf16; the hash -- BITWISE: the kernel, its
plain version on the card and ``hash_h`` on the CPU compute one
arithmetic (products rounded once, ``tree_sum``'s order, a division).
The case builders here are shared with ``test_torch_bucket_search.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import store_layout
from repro_torch.kernels import bucket_search as kbs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import lsh_hash as klh
from repro_torch.kernels import ssd_scan as kssd
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


def sorted_store_case(seed, n_sorted, n_tail, d, L, T, n_buckets=24, R=40):
    """A random store with a sorted CSR region (uint32 words above 2**31
    included) and an unsorted tail, plus R queries whose probes hit, miss
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


def _bitwise_equal(a, b):
    for x, y in zip(a, b):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        if x.dtype == np.float32:
            x, y = x.view(np.uint32), y.view(np.uint32)
        np.testing.assert_array_equal(x, y)


def _match_plain(got, want):
    np.testing.assert_allclose(got[0].cpu(), want[0].cpu(), **TOL)
    np.testing.assert_array_equal(got[1].cpu(), want[1].cpu())
    np.testing.assert_array_equal(got[2].cpu(), want[2].cpu())
    assert int(want[2].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 10, 128])
@pytest.mark.parametrize("d", [64, 432, 768, 3072])
def test_full_scan_kernel_any_width(d, K):
    """Widths past slice 1's limit (d > 416): fewer staged points, then
    depth slabs (d = 3072 is gemma-7b's embedding width).  The plain
    version runs on the card too."""
    dev = _cuda()
    query, store = to_torch(case(d + K, 200, 5000, d, 8, frac_match=0.5,
                                 T=2))
    query, store = _to(dev, query, True), _to(dev, store, True)
    want = ref.bucket_search_ref(query=query, store=store, cr2=2.0 * d,
                                 L=8, K=K)
    got = kbs.bucket_search_cuda(query=query, store=store, cr2=2.0 * d,
                                 L=8, K=K)
    torch.cuda.synchronize()
    _match_plain(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 432, 768, 3072])
def test_csr_bitwise_equal_full_scan_any_width(d):
    dev = _cuda()
    L, K, ns = 6, 5, 3000
    query, store = to_torch(sorted_store_case(d, ns, 37, d, L, 2),
                            n_sorted=ns)
    query, store = _to(dev, query), _to(dev, store)
    cr2 = 0.2 * d
    csr = ops.bucket_search(query=query, store=store, cr2=cr2, L=L, k=K)
    full = ops.bucket_search(query=query, store=store, cr2=cr2, L=L, k=K,
                             force_full_scan=True)
    torch.cuda.synchronize()
    _bitwise_equal(csr, full)
    _match_plain(csr, ref.bucket_search_ref(query=query, store=store,
                                            cr2=cr2, L=L, K=K))


def _redesign_case(kind, d):
    """A sorted region plus an unsorted tail for the match-first kernels:
    "hot_bucket" -- three buckets a table, every probe in one of them;
    "duplicate_probes" -- every row probes its first bucket three times;
    "rows_past_one_tile" -- 150 rows, over two 64-row tiles live;
    "odd_tail" -- the sorted region ends at an odd row, so the tail
    scan's columns start off their 16-byte alignment;
    "wide_probe_table" -- L = 80 probes a row, too many keys for the
    probe table to fit shared memory at any K: blocks probe it in
    global memory."""
    L = 80 if kind == "wide_probe_table" else 6
    ns, tail, R, nb = 3000, 500, 40, 24
    if kind == "hot_bucket":
        nb = 1
    elif kind == "rows_past_one_tile":
        R = 150
    elif kind == "odd_tail":
        ns, tail = 3001, 501
    c = sorted_store_case(d + len(kind), ns, tail, d, L, 2, n_buckets=nb,
                          R=R)
    if kind == "duplicate_probes":
        qb = c["qb"].reshape(R, L, 2)
        qb[:, 1:3] = qb[:, :1]
        c["probe"][:, :3] = 1
    if kind == "rows_past_one_tile":
        c["probe"][:, 0] = 1
    return L, ns, c


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 10, 128])
@pytest.mark.parametrize("d", [1, 3, 64, 432, 768, 3072])
@pytest.mark.parametrize("kind", ["hot_bucket", "duplicate_probes",
                                  "rows_past_one_tile", "odd_tail",
                                  "wide_probe_table"])
def test_match_first_kernels(kind, d, K):
    """The match-first full scan against its plain version, twice
    (bitwise the same: atomics order nothing that shows), also on a slice
    starting at row 1; the CSR path (gather + tail scan) bitwise equal to
    the full scan, its gather launched twice to the same bits."""
    dev = _cuda()
    L, ns, c = _redesign_case(kind, d)
    query, store = to_torch(c, n_sorted=ns)
    query, store = _to(dev, query), _to(dev, store)
    cr2 = 0.2 * d
    lead = lambda o: _to(dev, o, True)
    want = ref.bucket_search_ref(query=lead(query), store=lead(store),
                                 cr2=cr2, L=L, K=K)
    got = [kbs.bucket_search_cuda(query=lead(query), store=lead(store),
                                  cr2=cr2, L=L, K=K) for _ in range(2)]
    torch.cuda.synchronize()
    _match_plain(got[0], want)
    _bitwise_equal(got[0], got[1])
    sl = ops._slice(lead(store), 1, store.points.shape[0])
    _match_plain(kbs.bucket_search_cuda(query=lead(query), store=sl, cr2=cr2,
                                        L=L, K=K),
                 ref.bucket_search_ref(query=lead(query), store=sl, cr2=cr2,
                                       L=L, K=K))
    recorded = {}
    gather = kbs.bucket_gather_cuda

    def spy(*a, **kw):
        recorded["args"] = (a, kw)
        return gather(*a, **kw)
    ops.bucket_gather_cuda = spy
    try:
        csr = ops.bucket_search(query=query, store=store, cr2=cr2, L=L, k=K)
    finally:
        ops.bucket_gather_cuda = gather
    full = ops.bucket_search(query=query, store=store, cr2=cr2, L=L, k=K,
                             force_full_scan=True)
    a, kw = recorded["args"]
    torch.cuda.synchronize()
    _bitwise_equal(csr, full)
    _bitwise_equal(gather(*a, **kw), gather(*a, **kw))
    if kind == "rows_past_one_tile":
        assert int((query.probe > 0).any(-1).sum()) > kbs.TILE_R
    if kind == "wide_probe_table":
        R, N = query.q.shape[0], store.points.shape[0]
        assert not kbs.scan_plan(1, R, N, d, L, K).table_in_smem


@pytest.mark.gpu
def test_bucket_plans_mirror_the_kernels_shared_memory():
    """scan_plan / gather_plan size every block and the probe-table
    workspace as csrc/bucket_search.cu does."""
    _cuda()
    lib = kbs._lib()
    for K in range(1, kbs.MAX_K + 1):
        assert lib.bucket_gather_smem_bytes(K) == kbs.gather_plan(K)
        for L in (1, 2, 3, 8, 16, 17, 32, 33, 64, 100, 1000):
            p = kbs.scan_plan(8, 97, 1000, 64, L, K)
            assert lib.bucket_search_smem_bytes(
                K, p.table_slots, int(p.table_in_smem)) == p.smem_bytes
            assert lib.bucket_search_workspace_bytes(
                8, 97, K, p.n_splits, p.table_slots) == p.workspace_bytes


def _attn(seed, B, H, Hkv, Sq, Sk, dh, dtype, dev):
    rng = np.random.default_rng(seed)
    mk = lambda h, s: torch.from_numpy(
        (rng.standard_normal((B, h, s, dh)) * 0.5).astype(np.float32)
    ).to(dev, dtype)
    return mk(H, Sq), mk(Hkv, Sk), mk(Hkv, Sk)


def _attn_close(got, want):
    tol = 2e-5 if want.dtype == torch.float32 else 0.05
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 100, 128, 300])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 48, 64, 96, 128, 192, 256])
def test_flash_kernel_matches_plain_version(dh, dtype, causal, S):
    dev = _cuda()
    q, k, v = _attn(dh + S, 2, 4, 2, S, S, dh, dtype, dev)
    want = ref.attention_ref(q, k, v, causal=causal)
    before = kfa.flash_attention_cuda.launches
    got = kfa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kfa.flash_attention_cuda.launches == before + 1
    _attn_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hkv", [(8, 1), (6, 3)])
def test_flash_kernel_gqa_unequal_lengths_and_strided_views(H, Hkv):
    """MQA/GQA; non-causal Sq != Sk; q, k, v as views of (B, S, heads,
    dh) projections, as the attention layer passes them; the output
    keeps q's layout."""
    dev = _cuda()
    q, k, v = _attn(H, 2, H, Hkv, 70, 130, 64, torch.float32, dev)
    want = ref.attention_ref(q, k, v, causal=False)
    view = lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)
    got = kfa.flash_attention_cuda(view(q), view(k), view(v), causal=False)
    torch.cuda.synchronize()
    assert got.stride() == view(q).stride()
    _attn_close(got, want)


@pytest.mark.gpu
def test_flash_tensor_core_design_at_the_embedders_shape():
    """gemma-7b's layer shape (heads of 256, 128 tokens) at batch 2,
    causal, with v a view of its (B, S, H, dh) projection as
    ``models/attention.py`` passes it: the tensor-core design, within the
    bf16 tolerance of the plain version."""
    dev = _cuda()
    B, H, S, dh = 2, 16, 128, 256
    rng = np.random.default_rng(7)
    mk = lambda: torch.from_numpy(
        (rng.standard_normal((B, S, H, dh)) * 0.5).astype(np.float32)
    ).to(dev, torch.bfloat16)
    q = mk().transpose(1, 2).contiguous()
    k = mk().transpose(1, 2).contiguous()
    v = mk().transpose(1, 2)                     # strided (B, H, S, dh) view
    assert kfa.plan(q.dtype, dh, S).design == "tensor_core"
    want = ref.attention_ref(q, k, v, causal=True)
    before = dict(kfa.flash_attention_cuda.launches_by_design)
    got = kfa.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    after = kfa.flash_attention_cuda.launches_by_design
    assert after["tensor_core"] == before["tensor_core"] + 1
    assert after["cuda_core"] == before["cuda_core"]
    _attn_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dh,causal", [(36, True), (100, False)])
def test_flash_bf16_heads_off_the_tensor_core_grid_take_cuda_cores(dh,
                                                                   causal):
    """bf16 heads that are not a multiple of 16 keep the CUDA-core design
    (the plan decides before the launch) and its answers."""
    dev = _cuda()
    q, k, v = _attn(dh, 2, 4, 2, 77, 77, dh, torch.bfloat16, dev)
    before = dict(kfa.flash_attention_cuda.launches_by_design)
    got = kfa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = kfa.flash_attention_cuda.launches_by_design
    assert after["cuda_core"] == before["cuda_core"] + 1
    assert after["tensor_core"] == before["tensor_core"]
    _attn_close(got, ref.attention_ref(q, k, v, causal=causal))


@pytest.mark.gpu
def test_flash_kernel_rejects_bad_inputs():
    dev = _cuda()
    q, k, v = _attn(0, 1, 2, 2, 16, 24, 64, torch.float32, dev)
    with pytest.raises(ValueError, match="Sq == Sk"):
        kfa.flash_attention_cuda(q, k, v, causal=True)
    with pytest.raises(ValueError, match="share"):
        kfa.flash_attention_cuda(q, k.bfloat16(), v, causal=False)
    wide = torch.zeros((1, 2, 16, 260), device=dev)
    with pytest.raises(ValueError, match="head width"):
        kfa.flash_attention_cuda(wide, wide, wide)
    odd = torch.zeros((1, 2, 16, 128), device=dev)[..., ::2]
    with pytest.raises(ValueError, match="unit-stride"):
        kfa.flash_attention_cuda(odd, odd, odd)


@pytest.mark.gpu
def test_reduced_model_on_the_card_answers_as_on_the_cpu():
    """gemma-7b's reduced config (float32) through the kernel on the
    card against the plain version on the CPU, the same weights: one
    launch per layer; logits within rtol = atol = 1e-4."""
    dev = _cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    cfg = get_config("gemma-7b", reduced=True)
    cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    card = init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 100)))
    want, _ = forward(cpu, tokens)
    before = kfa.flash_attention_cuda.launches
    got, _ = forward(card, tokens.to(dev))
    torch.cuda.synchronize()
    assert kfa.flash_attention_cuda.launches == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def _ssd(seed, B, S, H, G, P, N, dtype, dev, mamba_decay=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g) * 0.5
    b = torch.randn((B, S, G, N), generator=g) * 0.3
    c = torch.randn((B, S, G, N), generator=g) * 0.3
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
    if mamba_decay:     # mamba2's own rates: a = -1 .. -16
        a_log = torch.log(torch.linspace(1.0, 16.0, H))
    else:
        a_log = torch.rand((H,), generator=g) * 2.5 - 2.0
    return (x.to(dev, dtype), a_log.to(dev), b.to(dev, dtype),
            c.to(dev, dtype), dt.to(dev))


def _ssd_close(got, want):
    tol = 2e-4 if want.dtype == torch.float32 else 0.05
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [128, 1000, 1024])
@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mamba_decay", [False, True])
def test_ssd_kernel_matches_plain_version(S, grouped, dtype, mamba_decay):
    """mamba2's head (P = 64, N = 128), G = 1 or G = H, ragged S."""
    dev = _cuda()
    H = 4
    args = _ssd(S, 2, S, H, 1 if grouped else H, 64, 128, dtype, dev,
                mamba_decay)
    want = ref.ssd_scan_ref(*args)
    before = kssd.ssd_scan_cuda.launches
    got = kssd.ssd_scan_cuda(*args)
    torch.cuda.synchronize()
    assert kssd.ssd_scan_cuda.launches == before + 1
    _ssd_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("P,N", [(4, 4), (16, 16), (32, 16), (8, 8),
                                 (100, 64), (128, 128)])
def test_ssd_kernel_other_widths(P, N):
    dev = _cuda()
    args = _ssd(P + N, 1, 300, 2, 2, P, N, torch.float32, dev)
    _ssd_close(kssd.ssd_scan_cuda(*args), ref.ssd_scan_ref(*args))


@pytest.mark.gpu
def test_ssd_kernel_carries_an_impulse_past_the_first_chunk():
    dev = _cuda()
    B, S, H, P, N = 1, 256, 1, 4, 4
    x = torch.zeros((B, S, H, P), device=dev)
    x[0, 0] = 1.0
    a_log = torch.tensor([-1.0], device=dev)
    b = torch.full((B, S, H, N), 0.5, device=dev)
    dt = torch.full((B, S, H), 0.1, device=dev)
    got = kssd.ssd_scan_cuda(x, a_log, b, b, dt)
    want = ref.ssd_scan_ref(x, a_log, b, b, dt)
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-4, atol=1e-6)
    assert float(got[0, 200, 0, 0].abs()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_reads_strided_views(dtype):
    """x, B and C as the SSM block passes them: views of one (B, S, ch)
    conv output; dt a transposed view."""
    dev = _cuda()
    B, S, H, P, G, N = 2, 200, 4, 32, 2, 16
    g = torch.Generator().manual_seed(1)
    xbc = (torch.randn((B, S, H * P + 2 * G * N), generator=g) * 0.4).to(
        dev, dtype)
    x, b, c = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    x, b, c = x.view(B, S, H, P), b.view(B, S, G, N), c.view(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.randn((B, H, S), generator=g))
    dt = dt.to(dev).transpose(1, 2)
    a_log = torch.zeros(H, device=dev)
    got = kssd.ssd_scan_cuda(x, a_log, b, c, dt)
    assert got.is_contiguous()
    want = ref.ssd_scan_ref(x.contiguous(), a_log, b.contiguous(),
                            c.contiguous(), dt.contiguous())
    _ssd_close(got, want)


@pytest.mark.gpu
def test_ssd_tensor_core_design_at_the_embedders_shape():
    """mamba2-130m's block shape (24 heads of 64, N = 128, one group) over
    1,024 tokens at batch 2: x, B and C as views of one (B, S, 1792) bf16
    conv output, mamba2's own decay rates; the tensor-core design, within
    the bf16 tolerance of the sequential plain version."""
    dev = _cuda()
    B, S, H, P, G, N = 2, 1024, 24, 64, 1, 128
    g = torch.Generator().manual_seed(3)
    xbc = (torch.randn((B, S, H * P + 2 * G * N), generator=g) * 0.5).to(
        dev, torch.bfloat16)
    x, b, c = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    x, b, c = x.view(B, S, H, P), b.view(B, S, G, N), c.view(B, S, G, N)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g) - 1.0).to(dev)
    a_log = torch.log(torch.linspace(1.0, 16.0, H)).to(dev)
    want = ref.ssd_scan_ref(x, a_log, b, c, dt)
    before = dict(kssd.ssd_scan_cuda.launches_by_design)
    got = kssd.ssd_scan_cuda(x, a_log, b, c, dt)
    torch.cuda.synchronize()
    after = kssd.ssd_scan_cuda.launches_by_design
    assert after["tensor_core"] == before["tensor_core"] + 1
    assert after["cuda_core"] == before["cuda_core"]
    _ssd_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("P,N", [(8, 8), (64, 144), (100, 64)])
def test_ssd_bf16_widths_off_the_tensor_core_grid_take_cuda_cores(P, N):
    dev = _cuda()
    args = _ssd(P * N, 1, 200, 2, 1, P, N, torch.bfloat16, dev, True)
    before = dict(kssd.ssd_scan_cuda.launches_by_design)
    got = kssd.ssd_scan_cuda(*args)
    torch.cuda.synchronize()
    assert (kssd.ssd_scan_cuda.launches_by_design["cuda_core"]
            == before["cuda_core"] + 1)
    _ssd_close(got, ref.ssd_scan_ref(*args))


@pytest.mark.gpu
def test_plans_mirror_the_kernels_shared_memory():
    """The wrappers' pure-Python plans size every block as csrc/ does."""
    _cuda()
    fl = kfa._lib()
    for dh in range(4, kfa.MAX_DH + 1, 4):
        for dtype in (torch.float32, torch.bfloat16):
            p = kfa.plan(dtype, dh, 128)
            design = 1 if p.design == "tensor_core" else 0
            assert fl.flash_attention_smem_bytes(design, dh) == p.smem_bytes
    sl = kssd._lib()
    for P in range(1, kssd.MAX_P + 1):
        for N in (1, 16, 17, 64, 128, 144, 256):
            assert sl.ssd_scan_smem_bytes(P, N) == \
                kssd.cuda_core_smem_bytes(P, N)
    for P in range(16, kssd.TC_MAX_P + 1, 16):
        for N in range(16, kssd.TC_MAX_N + 1, 16):
            assert sl.ssd_scan_tc_smem_bytes(P, N) == \
                kssd.plan(torch.bfloat16, P, N).smem_bytes


@pytest.mark.gpu
def test_ssd_kernel_rejects_bad_inputs():
    dev = _cuda()
    x, a_log, b, c, dt = _ssd(0, 1, 16, 4, 2, 16, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="head width"):
        wide = torch.zeros((1, 16, 4, 130), device=dev)
        kssd.ssd_scan_cuda(wide, a_log, b, c, dt)
    big = torch.zeros((1, 16, 2, 512), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        kssd.ssd_scan_cuda(x, a_log, big, big, dt)
    with pytest.raises(ValueError, match="one CUDA device"):
        kssd.ssd_scan_cuda(x, a_log.cpu(), b, c, dt)
    with pytest.raises(ValueError, match="share"):
        kssd.ssd_scan_cuda(x, a_log, b.bfloat16(), c, dt)


# ---------------------------------------------------------------------------
# The SSD gradient: kernel against the plain reverse recurrence
# ---------------------------------------------------------------------------

def _ssd_grads_close(got, want):
    """dx, db, dc, ddt, da_log: float32 within rtol 1e-4 and an atol of
    1e-4 of the output's largest magnitude (ddt and da_log are sums of
    terms that cancel; the kernel adds them in another order); bf16 dx,
    db, dc within the forward's bf16 tolerance, 0.05 (an output rounded to
    bf16 lands one bf16 step apart), ddt and da_log (float32 sums of bf16
    inputs) within 1e-3 of the largest magnitude."""
    bf16 = got[0].dtype == torch.bfloat16
    for name, g, w in zip(("dx", "db", "dc", "ddt", "da_log"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        g, w = g.float().cpu(), w.float().cpu()
        scale = max(1.0, float(w.abs().max()))
        if bf16 and name in ("dx", "db", "dc"):
            tol = dict(rtol=0.05, atol=0.05)
        else:
            rel = 1e-3 if bf16 else 1e-4
            tol = dict(rtol=rel, atol=rel * scale)
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (8, 1024, 24, 1, 64, 128),    # mamba2-130m's training step
    (2, 77, 4, 2, 32, 16),        # odd S, two groups
    (1, 33, 2, 2, 16, 40),        # P = 16, N off the 32-column slices
    (1, 50, 2, 1, 100, 64),       # P padded to 128
])
def test_ssd_bwd_kernel_matches_plain_version(dtype, shape):
    """Each shape's design: bf16 at P, N multiples of 16 (P <= 64, N <=
    128) the chunked "tensor_core" one, anything else "cuda_core"."""
    dev = _cuda()
    B, S, H, G, P, N = shape
    args = _ssd(S + P, B, S, H, G, P, N, dtype, dev, mamba_decay=H > 4)
    dy = (torch.randn((B, S, H, P), generator=torch.Generator()
                      .manual_seed(S)) * 0.5).to(dev, dtype)
    want = ref.ssd_scan_bwd_ref(*args, dy)
    design = ("tensor_core" if dtype == torch.bfloat16 and P % 16 == 0
              and N % 16 == 0 and P <= 64 and N <= 128 else "cuda_core")
    before = (kssd.ssd_scan_bwd_cuda.launches,
              kssd.ssd_scan_bwd_cuda.launches_by_design[design])
    got = kssd.ssd_scan_bwd_cuda(*args, dy)
    torch.cuda.synchronize()
    assert (kssd.ssd_scan_bwd_cuda.launches,
            kssd.ssd_scan_bwd_cuda.launches_by_design[design]) == (
        before[0] + 1, before[1] + 1)
    _ssd_grads_close(got, want)


def _strided_ssd(args):
    """x, b and c as the SSM block passes them: views of one tensor."""
    x, a_log, b, c, dt = args
    xbc = torch.cat([x.flatten(2), b.flatten(2), c.flatten(2)], dim=-1)
    xs, bs, cs = torch.split(xbc, [x[0, 0].numel(), b[0, 0].numel(),
                                   c[0, 0].numel()], dim=-1)
    return (xs.view(x.shape), a_log, bs.view(b.shape), cs.view(c.shape), dt)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (2, 300, 8, 2, 64, 128),
    (8, 1024, 24, 1, 64, 128),    # mamba2-130m's training step
])
def test_ssd_bwd_kernel_launches_are_bitwise_equal(shape):
    """No atomics: two launches on the same inputs give the same bits."""
    dev = _cuda()
    args = _ssd(7, *shape, torch.bfloat16, dev, True)
    x, a_log, b, c, dt = _strided_ssd(args)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)
                     ).to(dev, torch.bfloat16)
    before = kssd.ssd_scan_bwd_cuda.launches_by_design["tensor_core"]
    one = kssd.ssd_scan_bwd_cuda(x, a_log, b, c, dt, dy)
    two = kssd.ssd_scan_bwd_cuda(x, a_log, b, c, dt, dy)
    assert kssd.ssd_scan_bwd_cuda.launches_by_design["tensor_core"] == \
        before + 2
    for g1, g2 in zip(one, two):
        assert torch.equal(g1, g2)
    _ssd_grads_close(one, ref.ssd_scan_bwd_ref(x, a_log, b, c, dt, dy))


@pytest.mark.gpu
def test_ssd_bwd_plan_mirrors_the_kernel():
    """Both designs' shared memory and workspace, as the C side sizes
    them: "cuda_core" at every head width, "tensor_core" at every width
    it takes."""
    _cuda()
    lib = kssd._bwd_lib()
    for P in range(1, kssd.MAX_P + 1):
        for B, S, H, N in ((1, 1, 1, 1), (8, 1024, 24, 128), (2, 77, 4, 40),
                           (2, 77, 4, 16), (1, 130, 2, 96)):
            p = kssd.bwd_plan(torch.float32, B, S, H, P, N)
            assert p.design == "cuda_core"
            assert lib.ssd_scan_bwd_smem_bytes(P) == p.smem_bytes
            assert lib.ssd_scan_bwd_work_floats(B, S, H, P, N) == \
                p.work_floats
            p = kssd.bwd_plan(torch.bfloat16, B, S, H, P, N)
            if P % 16 or N % 16 or P > 64:
                assert p.design == "cuda_core"
                continue
            assert p.design == "tensor_core"
            assert lib.ssd_scan_bwd_tc_smem_bytes(P, N) == p.smem_bytes
            assert lib.ssd_scan_bwd_tc_work_floats(B, S, H, P, N) == \
                p.work_floats


@pytest.mark.gpu
def test_ssd_scan_op_gradient_at_the_training_shape_is_tensor_core():
    """``ops.ssd_scan``'s backward at mamba2-130m's training shape (8 x
    1,024 tokens, 24 heads of 64, N = 128, x, b, c as strided views)
    takes the "tensor_core" design, and its gradients are that launch's
    bits."""
    dev = _cuda()
    args = _strided_ssd(_ssd(13, 8, 1024, 24, 1, 64, 128, torch.bfloat16,
                             dev, True))
    leaves = [t.detach().requires_grad_() for t in args]
    dy = torch.randn(args[0].shape, generator=torch.Generator()
                     .manual_seed(3)).to(dev, torch.bfloat16)
    before = dict(kssd.ssd_scan_bwd_cuda.launches_by_design)
    ops.ssd_scan(*leaves).backward(dy)
    torch.cuda.synchronize()
    after = kssd.ssd_scan_bwd_cuda.launches_by_design
    assert (after["tensor_core"] - before["tensor_core"],
            after["cuda_core"] - before["cuda_core"]) == (1, 0)
    want = kssd.ssd_scan_bwd_cuda(*(t.detach() for t in args), dy)
    for leaf, w in zip(leaves, (want[0], want[4], want[1], want[2],
                                want[3])):
        assert torch.equal(leaf.grad, w)


@pytest.mark.gpu
def test_ssd_scan_op_gradient_is_the_kernels():
    """``ops.ssd_scan`` under autograd launches the forward kernel and, in
    backward, the gradient kernel: its gradients are the kernel's bits."""
    dev = _cuda()
    args = _ssd(11, 2, 200, 4, 1, 64, 128, torch.bfloat16, dev, True)
    leaves = [t.clone().requires_grad_() for t in args]
    dy = torch.randn(args[0].shape, generator=torch.Generator()
                     .manual_seed(2)).to(dev, torch.bfloat16)
    before = (kssd.ssd_scan_cuda.launches, kssd.ssd_scan_bwd_cuda.launches)
    y = ops.ssd_scan(*leaves)
    assert y.grad_fn is not None
    y.backward(dy)
    torch.cuda.synchronize()
    assert (kssd.ssd_scan_cuda.launches,
            kssd.ssd_scan_bwd_cuda.launches) == (before[0] + 1,
                                                 before[1] + 1)
    dx, db, dc, ddt, da_log = kssd.ssd_scan_bwd_cuda(*args, dy)
    x, a_log, b, c, dt = leaves
    for got, want in ((x.grad, dx), (b.grad, db), (c.grad, dc),
                      (dt.grad, ddt), (a_log.grad, da_log)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_reduced_training_step_on_the_card_equals_the_cpu():
    """Reduced mamba2 (float32): the loss and every gradient leaf on the
    card (the SSD forward and gradient kernels) against the CPU (their
    plain versions) at the CPU tests' tolerances (loss rtol 1e-5,
    gradients rtol = atol = 1e-4), then one AdamW step's parameters;
    two card steps bitwise alike."""
    dev = _cuda()
    from repro_torch import optim
    from repro_torch.tree import leaves_with_paths
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import (Transformer, init_params,
                                    load_param_tree, param_tree,
                                    value_and_grad)
    cfg = get_config("mamba2-130m", reduced=True)
    cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    card = Transformer(cfg, dev)
    load_param_tree(card, param_tree(cpu))
    tokens, labels = next(TokenPipeline(cfg.vocab, 2, 100, seed=1,
                                        device="cpu"))
    before = (kssd.ssd_scan_cuda.launches, kssd.ssd_scan_bwd_cuda.launches)
    with train.deterministic():
        lg, gg = value_and_grad(card, tokens.to(dev), labels.to(dev))
        torch.cuda.synchronize()
        assert (kssd.ssd_scan_cuda.launches - before[0],
                kssd.ssd_scan_bwd_cuda.launches - before[1]) == (
            2 * cfg.n_layers, cfg.n_layers)
        lc, gc = value_and_grad(cpu, tokens, labels)
        np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
        for (p, a), b in zip(zip(*leaves_with_paths(gg)),
                             leaves_with_paths(gc)[1]):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=p)
        opt = optim.AdamWConfig(warmup_steps=2, total_steps=4)
        state = lambda m: (param_tree(m), optim.init(param_tree(m)))
        on_card = [train.make_step(card, opt)(state(card), (
            tokens.to(dev), labels.to(dev)))[0][0] for _ in range(2)]
        on_cpu = train.make_step(cpu, opt)(state(cpu), (tokens, labels))[0][0]
    for a, b, c in zip(leaves_with_paths(on_card[0])[1],
                       leaves_with_paths(on_card[1])[1],
                       leaves_with_paths(on_cpu)[1]):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.gpu
def test_flash_attention_gradient_on_the_card_is_the_kernels():
    """The refusal this test held is gone: ``ops.flash_attention`` under
    autograd launches the forward kernel (with its lse) and, in backward,
    the gradient kernel, and its gradients are the kernel's bits; under
    ``no_grad`` it is the plain forward launch."""
    dev = _cuda()
    q, k, v = _attn(5, 2, 4, 2, 96, 96, 64, torch.bfloat16, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)
                       ).to(dev, torch.bfloat16)
    before = (kfa.flash_attention_cuda.launches,
              kfa.flash_attention_bwd_cuda.launches)
    o = ops.flash_attention(*leaves)
    assert o.grad_fn is not None
    o.backward(dout)
    torch.cuda.synchronize()
    assert (kfa.flash_attention_cuda.launches,
            kfa.flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                       before[1] + 1)
    o2, lse = kfa.flash_attention_cuda(q, k, v, return_lse=True)
    assert torch.equal(o.detach(), o2)
    want = kfa.flash_attention_bwd_cuda(q, k, v, o2, lse, dout)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    with torch.no_grad():
        assert ops.flash_attention(*leaves).grad_fn is None


# ---------------------------------------------------------------------------
# flash-attention gradient: the kernel against its plain version
# ---------------------------------------------------------------------------

def _bwd_case(seed, B, H, Hkv, Sq, Sk, dh, dtype, dev, causal):
    """q, k, v, the plain forward's o and lse, and a seeded dout."""
    q, k, v = _attn(seed, B, H, Hkv, Sq, Sk, dh, dtype, dev)
    o, lse = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
    rng = np.random.default_rng(seed + 1)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(dev, dtype)
    return q, k, v, o, lse, dout


def _bwd_close(got, want):
    """Each gradient within a tolerance of the largest magnitude of the
    three: 1e-4 in float32 (float32 sums in another order), 1e-2 in bf16
    (both round P and dS to bf16, and a value next to a rounding boundary
    may round the other way on one side; the outputs are bf16, a step of
    2**-8).  The largest of the three, not each one's own: with a single
    key dq and dk are 0 in exact arithmetic (dP - delta cancels), and
    both sides give rounding noise some 1e-8 of dv."""
    scale = max(float(w.float().abs().max()) for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = 1e-4 if w.dtype == torch.float32 else 1e-2
        g, w = g.float().cpu(), w.float().cpu()
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol,
                                   atol=tol * scale, err_msg=name)


def _bwd_design(dtype):
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 100, 300])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 96, 128, 192, 256])
def test_flash_bwd_kernel_matches_plain_version(dh, dtype, causal, S):
    dev = _cuda()
    a = _bwd_case(dh + S, 2, 4, 2, S, S, dh, dtype, dev, causal)
    want = ref.flash_attention_bwd_ref(*a, causal=causal)
    before = dict(kfa.flash_attention_bwd_cuda.launches_by_design)
    got = kfa.flash_attention_bwd_cuda(*a, causal=causal)
    torch.cuda.synchronize()
    after = kfa.flash_attention_bwd_cuda.launches_by_design
    design = _bwd_design(dtype)
    assert after[design] == before[design] + 1
    _bwd_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv", [(8, 1), (6, 3)])
def test_flash_bwd_kernel_gqa_unequal_lengths_and_strided_views(H, Hkv,
                                                                dtype):
    """MQA/GQA (dk, dv summed over each kv head's group); non-causal
    Sq != Sk, ragged against every tile; q, k, v, o and dout as views of
    (B, S, heads, dh) tensors, as the attention layer and autograd pass
    them; and a dout whose head dim is not unit-stride (copied once)."""
    dev = _cuda()
    a = _bwd_case(H, 2, H, Hkv, 70, 130, 64, dtype, dev, False)
    want = ref.flash_attention_bwd_ref(*a, causal=False)
    view = lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)
    q, k, v, o, lse, dout = a
    got = kfa.flash_attention_bwd_cuda(view(q), view(k), view(v), view(o),
                                       lse, view(dout), causal=False)
    torch.cuda.synchronize()
    _bwd_close(got, want)
    odd = dout.transpose(2, 3).contiguous().transpose(2, 3)
    assert odd.stride(3) != 1
    _bwd_close(kfa.flash_attention_bwd_cuda(q, k, v, o, lse, odd,
                                            causal=False), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_launches_are_bitwise_equal(dtype):
    """No atomics, every sum in a fixed order: two launches give the same
    bits (the training replay's premise), at gemma-7b's head width with
    GQA and causal rows."""
    dev = _cuda()
    a = _bwd_case(9, 2, 8, 2, 333, 333, 256, dtype, dev, True)
    one = kfa.flash_attention_bwd_cuda(*a)
    two = kfa.flash_attention_bwd_cuda(*a)
    torch.cuda.synchronize()
    for g1, g2 in zip(one, two):
        assert torch.equal(g1, g2)
    _bwd_close(one, ref.flash_attention_bwd_ref(*a))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_narrow_v_through_the_padding_wrappers(dtype):
    """MLA's widths, q/k 192 and v 128 (deepseek-v2-lite), causal: the
    forward wrapper zero-pads v for the kernel and returns O's first 128
    columns, the gradient wrapper pads v, o and dout and returns dV's;
    both against their plain versions (which take v as it is), one
    launch each, bf16 on the tensor-core designs; two gradient launches
    bitwise alike."""
    dev = _cuda()
    q, k, _ = _attn(192, 2, 4, 4, 300, 300, 192, dtype, dev)
    v = _attn(128, 2, 4, 4, 300, 300, 128, dtype, dev)[2]
    design = _bwd_design(dtype)
    before = (dict(kfa.flash_attention_cuda.launches_by_design),
              dict(kfa.flash_attention_bwd_cuda.launches_by_design))
    o, lse = kfa.flash_attention_cuda(q, k, v, return_lse=True)
    want_o, want_lse = ref.attention_ref(q, k, v, return_lse=True)
    assert o.shape == (2, 4, 300, 128)
    _attn_close(o, want_o)
    np.testing.assert_allclose(lse.cpu(), want_lse.cpu(), rtol=1e-4,
                               atol=1e-4)
    dout = torch.from_numpy(np.random.default_rng(3).standard_normal(
        o.shape).astype(np.float32)).to(dev, dtype)
    a = (q, k, v, o, lse, dout)
    got = kfa.flash_attention_bwd_cuda(*a)
    again = kfa.flash_attention_bwd_cuda(*a)
    torch.cuda.synchronize()
    assert got[2].shape == v.shape and got[2].is_contiguous()
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    _bwd_close(got, ref.flash_attention_bwd_ref(*a))
    after = (kfa.flash_attention_cuda.launches_by_design,
             kfa.flash_attention_bwd_cuda.launches_by_design)
    assert after[0][design] == before[0][design] + 1
    assert after[1][design] == before[1][design] + 2


@pytest.mark.gpu
def test_flash_bwd_tensor_core_design_at_the_training_shape():
    """gemma-7b's layer at the train path's shape (2 x 1,024 tokens, 16
    heads of 256, causal), q, k, v and dout as the views training hands
    over: the tensor-core design, within the bf16 tolerance."""
    dev = _cuda()
    B, H, S, dh = 2, 16, 1024, 256
    rng = np.random.default_rng(4)
    mk = lambda sc: torch.from_numpy((rng.standard_normal(
        (B, S, H, dh)) * sc).astype(np.float32)).to(
            dev, torch.bfloat16).transpose(1, 2)
    q, k, v, dout = mk(0.5), mk(0.5), mk(0.5), mk(1.0)
    o, lse = kfa.flash_attention_cuda(q, k, v, return_lse=True)
    before = dict(kfa.flash_attention_bwd_cuda.launches_by_design)
    got = kfa.flash_attention_bwd_cuda(q, k, v, o, lse, dout)
    torch.cuda.synchronize()
    assert kfa.flash_attention_bwd_cuda.launches_by_design[
        "tensor_core"] == before["tensor_core"] + 1
    _bwd_close(got, ref.flash_attention_bwd_ref(q, k, v, o, lse, dout))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,causal,Sq,Sk", [
    (32, True, 100, 100), (64, False, 70, 130), (96, True, 300, 300),
    (128, False, 1, 257), (256, True, 333, 333), (36, True, 77, 77)])
def test_flash_lse_does_not_change_the_output(dh, causal, Sq, Sk, dtype):
    """The forward's lse output: the output bitwise the same with and
    without it, the lse within rtol = atol = 1e-4 of the plain one (the
    same float32 scores, summed in another order), in both designs."""
    dev = _cuda()
    q, k, v = _attn(dh + Sq, 2, 4, 2, Sq, Sk, dh, dtype, dev)
    plain = kfa.flash_attention_cuda(q, k, v, causal=causal)
    o, lse = kfa.flash_attention_cuda(q, k, v, causal=causal,
                                      return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, plain)
    _, want = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
    assert lse.shape == (2, 4, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_flash_bwd_plan_mirrors_the_kernels_shared_memory():
    """bwd_plan's shared memory of each kernel is the C side's, at every
    width of both designs (the tensor-core design's from the padded
    width: its 64-column panels, two stages and the 1,024 bytes that
    align its swizzled tiles)."""
    _cuda()
    lib = kfa._bwd_lib()
    for dh in range(4, kfa.MAX_DH + 1, 4):
        for dtype in (torch.float32, torch.bfloat16):
            p = kfa.bwd_plan(dtype, dh, 128, 128)
            design = int(p.design == "tensor_core")
            assert design == (dtype == torch.bfloat16 and dh % 16 == 0)
            assert lib.flash_attention_bwd_smem_bytes(design, 0, dh) == \
                p.dkdv_smem_bytes, (dh, p)
            assert lib.flash_attention_bwd_smem_bytes(design, 1, dh) == \
                p.dq_smem_bytes, (dh, p)


@pytest.mark.gpu
def test_flash_bwd_kernel_rejects_bad_inputs():
    dev = _cuda()
    a = _bwd_case(0, 1, 2, 2, 16, 24, 64, torch.float32, dev, False)
    q, k, v, o, lse, dout = a
    with pytest.raises(ValueError, match="causal"):
        kfa.flash_attention_bwd_cuda(*a, causal=True)
    with pytest.raises(ValueError, match="lse"):
        kfa.flash_attention_bwd_cuda(q, k, v, o, lse[:, :, :3], dout,
                                     causal=False)
    with pytest.raises(ValueError, match="dout"):
        kfa.flash_attention_bwd_cuda(q, k, v, o, lse, dout.bfloat16(),
                                     causal=False)


@pytest.mark.gpu
def test_reduced_dense_training_step_on_the_card_equals_the_cpu():
    """Reduced gemma-7b (float32, heads of 48: the CUDA-core designs):
    the loss and every gradient leaf on the card (the flash forward and
    gradient kernels) against the CPU (their plain versions) at the CPU
    tests' tolerances (loss rtol 1e-5, gradients rtol = atol = 1e-4),
    then one AdamW step's parameters; two card steps bitwise alike."""
    _training_step_on_the_card_equals_the_cpu("gemma-7b")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b"])
def test_reduced_moe_training_step_on_the_card_equals_the_cpu(arch):
    """The same for the MoE family: the router, the dispatch and combine,
    the expert products and (deepseek) MLA's flash launches with v
    narrower than q and k, on the card against the CPU."""
    _training_step_on_the_card_equals_the_cpu(arch)


def _training_step_on_the_card_equals_the_cpu(arch):
    dev = _cuda()
    from repro_torch import optim
    from repro_torch.tree import leaves_with_paths
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import (Transformer, init_params,
                                    load_param_tree, param_tree,
                                    value_and_grad)
    cfg = get_config(arch, reduced=True)
    cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    card = Transformer(cfg, dev)
    load_param_tree(card, param_tree(cpu))
    tokens, labels = next(TokenPipeline(cfg.vocab, 2, 100, seed=1,
                                        device="cpu"))
    before = (kfa.flash_attention_cuda.launches,
              kfa.flash_attention_bwd_cuda.launches)
    with train.deterministic():
        lg, gg = value_and_grad(card, tokens.to(dev), labels.to(dev))
        torch.cuda.synchronize()
        assert (kfa.flash_attention_cuda.launches - before[0],
                kfa.flash_attention_bwd_cuda.launches - before[1]) == (
            2 * cfg.n_layers, cfg.n_layers)
        lc, gc = value_and_grad(cpu, tokens, labels)
        np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
        for (p, a), b in zip(zip(*leaves_with_paths(gg)),
                             leaves_with_paths(gc)[1]):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=p)
        opt = optim.AdamWConfig(warmup_steps=2, total_steps=4)
        state = lambda m: (param_tree(m), optim.init(param_tree(m)))
        on_card = [train.make_step(card, opt)(state(card), (
            tokens.to(dev), labels.to(dev)))[0][0] for _ in range(2)]
        on_cpu = train.make_step(cpu, opt)(state(cpu), (tokens, labels))[0][0]
    for a, b, c in zip(leaves_with_paths(on_card[0])[1],
                       leaves_with_paths(on_card[1])[1],
                       leaves_with_paths(on_cpu)[1]):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# p-stable hash: BITWISE kernel = plain version on the card = CPU hash_h
# ---------------------------------------------------------------------------

def _hash_equal(got, *wants):
    """Every output bit equal (ints, or the float quotient's bits)."""
    for want in wants:
        assert got.dtype == want.dtype and got.shape == want.shape
        g, w = got.cpu(), want.cpu()
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), float((g != w).double().mean())


def _hash_case(n, d, K, T=None, seed=0):
    g = torch.Generator().manual_seed(seed + n + d + K)
    x = torch.randn((n, d), generator=g) / d ** 0.5
    shape = (d, K) if T is None else (T, d, K)
    a = torch.randn(shape, generator=g)
    b = torch.rand(shape[:-2] + (K,), generator=g) * 0.5
    return x, a, b


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,K", [(1000, 64, 20), (257, 100, 130),
                                   (3, 768, 7), (4097, 64, 256),
                                   (130, 50, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lsh_hash_kernel_matches_plain_version(n, d, K, dtype):
    dev = _cuda()
    x, a, b = _hash_case(n, d, K)
    x = x.to(dtype)
    want = ref.lsh_hash_ref(x, a, b, w=0.5)                    # on the CPU
    x, a, b = x.to(dev), a.to(dev), b.to(dev)
    before = klh.lsh_hash_cuda.launches
    got = klh.lsh_hash_cuda(x, a, b, w=0.5)
    torch.cuda.synchronize()
    assert klh.lsh_hash_cuda.launches == before + 1
    _hash_equal(got, ref.lsh_hash_ref(x, a, b, w=0.5), want)
    # x read through its strides: a transposed view
    xt = x.t().contiguous().t()
    _hash_equal(klh.lsh_hash_cuda(xt, a, b, w=0.5), got)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 10, 20, 33])
@pytest.mark.parametrize("d", [1, 3, 64, 768, 3072])
@pytest.mark.parametrize("n", [1, 61, 1001])
def test_lsh_hash_kernel_bitwise_at_every_width(n, d, K):
    dev = _cuda()
    x, a, b = _hash_case(n, d, K)
    x[0, : (d + 1) // 2] = -0.0                   # signed zeros in a dot
    want = ref.lsh_hash_ref(x, a, b, w=0.25)
    quot = ref.lsh_hash_ref(x, a, b, w=0.25, floor=False)
    x, a, b = x.to(dev), a.to(dev), b.to(dev)
    _hash_equal(klh.lsh_hash_cuda(x, a, b, w=0.25), want)
    _hash_equal(klh.lsh_hash_cuda(x, a, b, w=0.25, floor=False), quot)
    _hash_equal(klh.lsh_hash_cuda(x.bfloat16(), a, b, w=0.25),
                ref.lsh_hash_ref(x.bfloat16().cpu(), a.cpu(), b.cpu(),
                                 w=0.25))
    # an unaligned strided view: every other row, from the second column
    wide = torch.zeros((2 * n, d + 1), device=dev)
    wide[::2, 1:] = x
    _hash_equal(klh.lsh_hash_cuda(wide[::2, 1:], a, b, w=0.25), want)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("d,K", [(64, 10), (768, 8), (3072, 8), (10, 1),
                                 (3, 33)])
def test_lsh_hash_kernel_per_row_tables(T, d, K):
    """Stacked a (T, d, K): each row under its table id, or under x's
    leading axis; int32 x as hk.to(float32) reads it."""
    dev = _cuda()
    x, a, b = _hash_case(8 * 13 * 4, d, K, T=T)
    x = x.reshape(8, 13, 4, d)
    tab = torch.from_numpy(np.random.default_rng(T).integers(
        0, T, (8, 13)).astype(np.int32))
    want = ref.lsh_hash_ref(x, a, b, w=0.5, table=tab)
    xd, ad, bd, td = x.to(dev), a.to(dev), b.to(dev), tab.to(dev)
    _hash_equal(klh.lsh_hash_cuda(xd, ad, bd, w=0.5, table=td),
                ref.lsh_hash_ref(xd, ad, bd, w=0.5, table=td), want)
    xl = x.reshape(T, -1, d)
    _hash_equal(klh.lsh_hash_cuda(xl.to(dev), ad, bd, w=0.5),
                ref.lsh_hash_ref(xl, a, b, w=0.5))
    xi = (x * 1000).to(torch.int32)
    _hash_equal(klh.lsh_hash_cuda(xi.to(dev), ad, bd, w=0.5, table=td),
                ref.lsh_hash_ref(xi, a, b, w=0.5, table=tab))
    bad = td.clone()
    bad[0, 0] = T
    got = klh.lsh_hash_cuda(xd, ad, bd, w=0.5, table=bad).cpu()
    assert torch.all(got[0, 0] == -2 ** 31)
    assert torch.equal(got[1:], want[1:])


@pytest.mark.gpu
def test_lsh_hash_kernel_agrees_with_the_index_hash():
    dev = _cuda()
    from repro_torch.core import DistributedLSHIndex, LSHConfig
    from repro_torch.core.hashing import hash_h
    cfg = LSHConfig(d=64, k=10, W=1.0, r=0.3, c=2.0, L=4, n_shards=2,
                    n_tables=2)
    params = DistributedLSHIndex(cfg, device=dev).stacked_params
    x = torch.randn((5000, 64), generator=torch.Generator().manual_seed(0))
    x = (x / 8.0).to(dev)
    A = torch.cat([params.table(t).A for t in range(2)], dim=1)
    b = torch.cat([params.table(t).b for t in range(2)])
    got = ops.lsh_hash(x, A, b, w=cfg.W)
    cpu = params.to("cpu")
    for t in range(2):
        _hash_equal(got[:, 10 * t:10 * (t + 1)],
                    hash_h(params.table(t), x, cfg.W),
                    hash_h(cpu.table(t), x.cpu(), cfg.W))


@pytest.mark.gpu
def test_lsh_hash_kernel_rejects_bad_inputs():
    dev = _cuda()
    x = torch.zeros((4, 8), device=dev)
    a = torch.zeros((8, 3), device=dev)
    b = torch.zeros((3,), device=dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        klh.lsh_hash_cuda(x, a.cpu(), b, w=1.0)
    with pytest.raises(ValueError, match="float32"):
        klh.lsh_hash_cuda(x, a.half(), b, w=1.0)
    with pytest.raises(ValueError, match="positive"):
        klh.lsh_hash_cuda(x, a, b, w=-1.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        klh.lsh_hash_cuda(x, a[None], b[None], w=1.0,
                          table=torch.zeros(4, dtype=torch.int32))
    assert klh.lsh_hash_cuda(x[:0], a, b, w=1.0).shape == (0, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["layered", "simple"])
def test_index_hashes_through_the_kernel(scheme):
    """Insert, dispatch and receive side hash on the card through the
    kernel, never the plain version, and answer as a CPU index from the
    same seed, integers equal."""
    dev = _cuda()
    from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme
    cfg = LSHConfig(d=64, k=10, W=1.0, r=0.3, c=2.0, L=8, n_shards=8,
                    n_tables=2, scheme=Scheme(scheme))
    rng = np.random.default_rng(5)
    data = (rng.standard_normal((6000, 64)) / 8).astype(np.float32)
    qs = data[rng.integers(0, 5000, 96)] + (
        rng.standard_normal((96, 64)) * 0.02).astype(np.float32)
    plain_calls = []
    real_ref = ref.lsh_hash_ref

    def spy(x, *a, **kw):
        plain_calls.append(x.device.type)
        return real_ref(x, *a, **kw)
    out = {}
    ref.lsh_hash_ref = spy
    try:
        for name in ("cpu", dev):
            idx = DistributedLSHIndex(cfg, device=name, k_neighbors=5)
            before = klh.lsh_hash_cuda.launches
            idx.build(data[:5000])
            built = klh.lsh_hash_cuda.launches - before
            before = klh.lsh_hash_cuda.launches
            a = idx.query(qs)
            queried = klh.lsh_hash_cuda.launches - before
            idx.insert(data[5000:])
            b = idx.query(qs)
            out[str(name)] = (a, b, built, queried)
    finally:
        ref.lsh_hash_ref = real_ref
    assert "cuda" not in plain_calls and "cpu" in plain_calls
    _, _, built, queried = out[str(dev)]
    # insert: H, plus G for layered; a query: dispatch and receive side
    assert built == (2 if scheme == "layered" else 1)
    assert queried == 2 * built
    assert out["cpu"][2:] == (0, 0)
    for got, want in zip(out[str(dev)][:2], out["cpu"][:2]):
        for f in ("topk_gid", "n_within_cr", "fq", "query_load"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_allclose(got.topk_dist, want.topk_dist, **TOL)


# ---------------------------------------------------------------------------
# reduced mamba2 on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_reduced_mamba2_on_the_card_answers_as_on_the_cpu():
    """Reduced mamba2 (float32) through the SSD kernel on the card against
    the plain version on the CPU, the same weights: one launch per layer,
    logits within rtol = atol = 1e-4; then its retrieval service gives
    the CPU's embeddings within 1e-4 and the same exchanges and drops."""
    dev = _cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.serving import RetrievalService, embed_texts
    cfg = get_config("mamba2-130m", reduced=True)
    cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    card = init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 300)))
    want, _ = forward(cpu, tokens)
    before = kssd.ssd_scan_cuda.launches
    got, _ = forward(card, tokens.to(dev))
    torch.cuda.synchronize()
    assert kssd.ssd_scan_cuda.launches == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)

    docs = np.random.default_rng(1).integers(0, cfg.vocab, (128, 40))
    lsh = dict(n_shards=8, bucket_size=64, r=0.2, L=8, k=8, W=0.5)
    svc_cpu = RetrievalService.build(cfg, cpu, docs, device="cpu", **lsh)
    svc_card = RetrievalService.build(cfg, card, docs, device=dev, **lsh)
    np.testing.assert_allclose(embed_texts(card, docs[:64]).cpu(),
                               embed_texts(cpu, docs[:64]), rtol=1e-4,
                               atol=1e-4)
    for svc in (svc_cpu, svc_card):
        g, d, _ = svc.query(docs[:64])
        assert g.shape == (64, 1) and svc.service.stats.drops == 0
        assert svc.index.a2a.calls == 3


# ---------------------------------------------------------------------
# The staged query, the pipelined service and snapshots on the card
# ---------------------------------------------------------------------

def _stream_data(n=4096, m=256, d=32, seed=5):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    qs = data[rng.integers(0, n, m)] + (
        rng.standard_normal((m, d)) * 0.05).astype(np.float32)
    return data, qs


def _stream_cfg(T=2, S=8):
    from repro_torch.core import LSHConfig
    return LSHConfig(d=32, k=8, W=1.2, r=0.3, c=2.0, L=8, n_shards=S,
                     n_tables=T)


def _same_answers(a, b):
    for f in ("topk_gid", "n_within_cr", "fq", "query_load"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.topk_dist.view(np.uint32),
                                  b.topk_dist.view(np.uint32))
    assert a.drops == b.drops == 0


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2])
def test_staged_query_on_the_card_bitwise_equals_fused(T):
    dev = _cuda()
    from repro_torch.core import DistributedLSHIndex
    data, qs = _stream_data()
    idx = DistributedLSHIndex(_stream_cfg(T), device=dev, k_neighbors=5)
    idx.build(data[:3000])
    for step in ("unsorted", "sorted + tail"):
        if step != "unsorted":
            idx.compact()
            idx.insert(data[3000:])
        calls = idx.a2a.calls
        disp = idx.query_dispatch(qs)
        assert idx.a2a.calls == calls + 1
        scanned = idx.query_scan(disp)
        assert idx.a2a.calls == calls + 1
        idx.query_return(scanned)
        assert idx.a2a.calls == calls + 2
        _same_answers(idx.query_staged(qs), idx.query(qs))


@pytest.mark.gpu
def test_async_stream_on_the_card_bitwise_equals_sync():
    """Depth 2: a batch's pinned staging slot is refilled only after its
    non-blocking copy ran.  Refilling early would hand a batch the next
    bucket's queries -- caught here as an answer that differs from the
    synchronous service's."""
    dev = _cuda()
    from repro_torch.core import DistributedLSHIndex
    from repro_torch.serving import (AsyncLSHService, QueryPipeline,
                                     ShardedLSHService)
    data, qs = _stream_data(m=1024)

    def index():
        idx = DistributedLSHIndex(_stream_cfg(), device=dev, k_neighbors=5)
        idx.build(data[:3000])
        return idx

    def drive(svc):
        handles = []
        for step in range(4):
            handles += svc.submit_batch(qs[256 * step:256 * step + 200])
            svc.insert(data[3000 + 200 * step:3200 + 200 * step])
            svc.delete(np.arange(step, 3000, 97))
            handles += svc.submit_batch(qs[:40])
        svc.drain()
        return (np.stack([h.gids for h in handles]),
                np.stack([h.dists for h in handles]),
                np.asarray([h.fq for h in handles]))

    sync = ShardedLSHService(index(), bucket_size=64,
                             max_latency_ms=float("inf"), k_neighbors=5)
    g0, d0, f0 = drive(sync)
    with AsyncLSHService(index(), bucket_size=64,
                         max_latency_ms=float("inf"), k_neighbors=5,
                         pipeline_depth=2) as asvc:
        g1, d1, f1 = drive(asvc)
    np.testing.assert_array_equal(g0, g1)
    np.testing.assert_array_equal(d0.view(np.uint32), d1.view(np.uint32))
    np.testing.assert_array_equal(f0, f1)
    # back-to-back buckets through the pipeline alone: every slot reused
    idx = index()
    pipe = QueryPipeline(idx, 64, depth=2)
    handles = [[type("H", (), {"t_submit": 0.0})() for _ in range(64)]
               for _ in range(16)]
    for b in range(16):
        pipe.submit(list(qs[64 * b:64 * b + 64]), handles[b])
    pipe.drain()
    for b in range(16):
        want = idx.query(qs[64 * b:64 * b + 64], k_neighbors=5)
        np.testing.assert_array_equal(
            np.stack([h.gids for h in handles[b]]), want.topk_gid)
        np.testing.assert_array_equal(
            np.stack([h.dists for h in handles[b]]).view(np.uint32),
            want.topk_dist.view(np.uint32))


@pytest.mark.gpu
def test_cpu_snapshot_restores_on_the_card(tmp_path):
    """A snapshot (and WAL tail) written on the CPU restores and recovers
    on the card: integers equal, distances within tolerance of the CPU
    index's answers; elastic restore at S = 4 on the card answers as the
    restore at S = 8."""
    dev = _cuda()
    from repro_torch import persist
    from repro_torch.core import DistributedLSHIndex
    from repro_torch.serving import ShardedLSHService
    data, qs = _stream_data()
    snap = str(tmp_path)
    idx = DistributedLSHIndex(_stream_cfg(), device="cpu", k_neighbors=5)
    idx.build(data[:3000])
    idx.delete(np.arange(0, 3000, 11))
    wal = persist.WriteAheadLog(persist.wal_path(snap))
    persist.snapshot(idx, snap, wal=wal)
    want0 = idx.query(qs)
    svc = ShardedLSHService(idx, bucket_size=64, wal=wal)
    svc.insert(data[3000:])
    svc.delete(np.arange(1, 3000, 13))
    wal.close()
    want1 = idx.query(qs)
    got0 = persist.restore(snap, device=dev)
    assert got0.device.type == "cuda"
    rr = persist.recover(snap, device=dev)
    elastic = persist.restore(snap, device=dev, n_shards=4)
    for got, want in ((got0.query(qs), want0),
                      (rr.index.query(qs), want1)):
        for f in ("topk_gid", "n_within_cr", "fq", "query_load"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_allclose(got.topk_dist, want.topk_dist, **TOL)
    e = elastic.query(qs)
    g = got0.query(qs)
    np.testing.assert_array_equal(e.topk_gid, g.topk_gid)
    np.testing.assert_array_equal(e.topk_dist.view(np.uint32),
                                  g.topk_dist.view(np.uint32))
    rr.wal.close()


# ---------------------------------------------------------------------------
# the simulator, the oracle and the datasets on the card
# ---------------------------------------------------------------------------

def _sim_cfg(scheme="layered", T=1, probes="entropy"):
    """Random's d, r and k with the index tests' wider W = 1.2, so that a
    few hundred queries find their planted points and the recall fields
    compared are not all zero (at W = 0.5 the recall is about 0.0025)."""
    from repro_torch.core import LSHConfig, Scheme
    return LSHConfig(d=100, k=10, W=1.2, r=0.3, c=2.0, L=16, n_shards=64,
                     scheme=Scheme(scheme), n_tables=T, probes=probes)


def _sim_data(n=8192, m=512):
    from repro_torch.data import planted_random
    data, queries, _ = planted_random(n, m, d=100, r=0.3, seed=0,
                                      device="cpu")
    return data, queries


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,T,probes", [
    ("layered", 2, "entropy"), ("simple", 1, "entropy"),
    ("layered", 1, "mplsh"), ("cauchy", 2, "entropy"), ("sum", 1, "mplsh")])
def test_simulate_on_the_card_equals_the_cpu(scheme, T, probes):
    """Every field of the card's reports equals the CPU's: the hashes are
    the kernel's bits, offsets and probes agree across devices, and no
    recall-deciding distance sits within a rounding of r or cr here."""
    import dataclasses
    from repro_torch.core import simulate, simulate_stream
    dev = _cuda()
    cfg = _sim_cfg(scheme, T, probes)
    data, queries = _sim_data()
    got = simulate(cfg, data.to(dev), queries.to(dev), compute_recall=True,
                   k_neighbors=10)
    want = simulate(cfg, data, queries, compute_recall=True,
                    k_neighbors=10, device="cpu")
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert want.query_rows > 0 and want.recall > 0
    kw = dict(n_prefix=4096, insert_batch=2048, query_batch=128)
    got = simulate_stream(cfg, data, queries, **kw)
    want = simulate_stream(cfg, data, queries, device="cpu", **kw)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert np.array_equal(a, b), f.name


@pytest.mark.gpu
def test_nearest_neighbors_on_the_card_equals_the_cpu():
    """The oracle's top-10 on the card: gids equal, distances within
    rtol = atol = 1e-5 (the card's and the CPU's matmul sum in their own
    orders, in IEEE float32)."""
    from repro_torch.core import lsh_topk_reference, nearest_neighbors
    dev = _cuda()
    data, queries = _sim_data()
    gd, gg = nearest_neighbors(data.to(dev), queries, 10)
    wd, wg = nearest_neighbors(data, queries, 10, device="cpu")
    np.testing.assert_array_equal(gg, wg)
    np.testing.assert_allclose(gd, wd, **TOL)
    cfg = _sim_cfg(T=2)
    gd, gg = lsh_topk_reference(cfg, data, queries, 10)
    wd, wg = lsh_topk_reference(cfg, data, queries, 10, device="cpu")
    np.testing.assert_array_equal(gg, wg)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_allclose(gd[fin], wd[fin], **TOL)


@pytest.mark.gpu
def test_prng_draws_and_offsets_on_the_card_equal_the_cpu():
    """Normal draws (their erfinv tail takes a square root) and entropy
    offsets (a norm's square root) are BITWISE the CPU's: torch's float32
    sqrt on the card is an ulp off on some inputs, so both root in
    float64 (``types.sqrt_f32``)."""
    from repro_torch.core import offsets, prng
    dev = _cuda()
    key = prng.split(prng.PRNGKey(0), 3)[0]
    want = prng.normal(key, (1 << 20,))
    assert torch.equal(prng.normal(key.to(dev), (1 << 20,)).cpu(), want)
    assert (want.abs() > 3.3).any()          # the erfinv tail is drawn
    qs = torch.randn((512, 100), generator=torch.Generator().manual_seed(0))
    qids = torch.arange(512, dtype=torch.int32)
    want = offsets.query_offsets(key, qids, qs, 64, 0.3)
    got = offsets.query_offsets(key.to(dev), qids.to(dev), qs.to(dev), 64,
                                0.3)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_simulator_hashes_launch_the_kernel():
    """On the card every H, G and Gamma of the simulator, the probes, the
    oracle and dedup launches the hash kernel, never the plain version;
    the datasets draw there, the same bits as on the CPU."""
    from repro_torch.core import lsh_topk_reference, simulate
    from repro_torch.data import dedup_embeddings, planted_random
    dev = _cuda()
    plain_calls = []
    real_ref = ref.lsh_hash_ref

    def spy(x, *a, **kw):
        plain_calls.append(x.device.type)
        return real_ref(x, *a, **kw)
    ref.lsh_hash_ref = spy
    try:
        data, queries, idx = planted_random(8192, 256, device=dev)
        cpu = planted_random(8192, 256, device="cpu")
        for g, w in zip((data, queries, idx), cpu):
            assert torch.equal(g.cpu(), w)
        before = klh.lsh_hash_cuda.launches
        for probes in ("entropy", "mplsh"):
            simulate(_sim_cfg(probes=probes), data, queries,
                     compute_recall=True)
        lsh_topk_reference(_sim_cfg(T=2), data, queries, 10)
        keep = dedup_embeddings(torch.cat([data, queries]), r=0.3)
        launched = klh.lsh_hash_cuda.launches - before
    finally:
        ref.lsh_hash_ref = real_ref
    assert launched > 0 and "cuda" not in plain_calls
    np.testing.assert_array_equal(
        keep, dedup_embeddings(torch.cat(cpu[:2]), r=0.3, device="cpu"))


# ---------------------------------------------------------------------------
# the decode and cache path
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-7b", "mistral-nemo-12b",
                                  "mamba2-130m", "granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "recurrentgemma-2b",
                                  "whisper-medium", "pixtral-12b"])
def test_reduced_decode_on_the_card_equals_the_cpu(arch):
    """Reduced configs (float32): a prompt prefilled into a cache and
    four decode steps on the card (a dense prompt through the flash
    kernel) against the CPU: every step's logits and every cache leaf
    within rtol = atol = 1e-4, the CPU tests' model tolerance; the
    position an int and a 0-d tensor on the device.  The prompt is 31
    tokens (recurrentgemma's 70, past its window of 64; pixtral's after
    16 stub patch rows; whisper's with 30 stub encoder frames)."""
    dev = _cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import (Transformer, decode_step, init_cache,
                                    init_params, load_param_tree,
                                    param_tree, prefill)
    from repro_torch.tree import leaves_with_paths
    cfg = get_config(arch, reduced=True)
    cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    card = Transformer(cfg, dev)
    load_param_tree(card, param_tree(cpu))
    S = 70 if cfg.rglru is not None else 31
    P = cfg.frontend_tokens
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, S + 4)))
    stubs = {}
    if P:
        stubs["frontend_emb"] = torch.from_numpy(rng.standard_normal(
            (2, P, cfg.d_model)).astype(np.float32))
    if cfg.encoder_layers:
        stubs["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_frames, cfg.d_model)).astype(np.float32))
    runs = []
    for model, d in ((cpu, "cpu"), (card, dev)):
        toks = tokens.to(d)
        cache = init_cache(cfg, 2, P + S + 5, device=d)
        logits, cache = prefill(model, toks[:, :S], cache, **{
            k: t.to(d) for k, t in stubs.items()})
        out = [logits]
        for t in range(S, S + 4):
            pos = P + t
            p = pos if pos % 2 else torch.tensor(pos, device=d)
            logits, cache = decode_step(model, toks[:, t:t + 1], cache, p)
            out.append(logits)
        runs.append((torch.cat(out, 1).cpu(), leaves_with_paths(cache)))
    (lc, (paths, cc)), (lg, (_, cg)) = runs
    np.testing.assert_allclose(lg.numpy(), lc.numpy(), rtol=1e-4, atol=1e-4)
    for path, c, g in zip(paths, cc, cg):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


@pytest.mark.gpu
def test_bf16_decode_scores_make_no_float32_copy_of_the_cache():
    """One bf16 decode step's attention at gemma-7b's layer shape (B = 8,
    16 kv heads of 256, Smax 2,080) allocates less than a float32 copy of
    the cache's K alone (half of one layer's K/V in float32): the
    products read K and V in bf16 and sum in float32."""
    dev = _cuda()
    from repro_torch.models import attention as attn
    B, H, S, dh = 8, 16, 2080, 256
    g = torch.Generator(device=dev).manual_seed(0)
    kc, vc = (torch.randn((B, H, S, dh), generator=g, device=dev)
              .bfloat16() for _ in range(2))
    q, kn, vn = (torch.randn((B, H, 1, dh), generator=g, device=dev)
                 .bfloat16() for _ in range(3))
    want = attn._decode_attn_delta(q, kc, vc, kn, vn, 2048, None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = attn._decode_attn_delta(q, kc, vc, kn, vn, 2048, None)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra < B * H * S * dh * 4, extra
    assert torch.equal(got, want)
    plain = attn._decode_attn_delta(q.cpu(), kc.cpu(), vc.cpu(), kn.cpu(),
                                    vn.cpu(), 2048, None)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               plain.float().numpy(), rtol=0.05, atol=0.05)


@pytest.mark.gpu
def test_prefill_launches_the_flash_kernel_once_a_dense_block():
    """A prompt at position 0 runs the flash kernel once a block (on its
    own q, k, v); a decode step and a prompt at a later position run
    none."""
    dev = _cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill)
    cfg = get_config("gemma-7b", reduced=True)
    model = init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=dev)
    cache = init_cache(cfg, 2, 48, device=dev)
    before = kfa.flash_attention_cuda.launches
    prefill(model, tokens[:, :32], cache)
    assert kfa.flash_attention_cuda.launches - before == cfg.n_layers
    before = kfa.flash_attention_cuda.launches
    decode_step(model, tokens[:, 32:33], cache, 32)
    from repro_torch.models.transformer import _blocks, _inputs
    _blocks(model, _inputs(model, tokens[:, 33:40], None, None)[0], pos0=33,
            cache=cache)
    torch.cuda.synchronize()
    assert kfa.flash_attention_cuda.launches == before


# ---------------------------------------------------------------------------
# the MoE MLP
# ---------------------------------------------------------------------------

def _moe_case(arch, dtype, dev, capacity_factor=1.0, T=(2, 48)):
    """A reduced MoE layer of ``arch`` at ``capacity_factor`` (1.0 drops
    tokens), its weights and input drawn on the CPU, on the CPU and on
    ``dev``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype,
                              moe=dataclasses.replace(
                                  cfg.moe, capacity_factor=capacity_factor))
    gen = torch.Generator().manual_seed(0)
    cpu = moe.MoE(cfg, device="cpu")
    for mod in cpu.modules():           # the shared MLP resets itself
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    card = moe.MoE(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((*T, cfg.d_model), generator=gen).to(cfg.cdtype)
    return cfg, cpu, card, x


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b"])
def test_moe_mlp_on_the_card_equals_the_cpu(arch):
    """float32, with tokens dropped (capacity 1): the same experts, slots
    and drops (the router in IEEE float32 on both), the output and the
    balance loss within rtol = atol = 1e-4, and the gradients of x and
    every parameter."""
    dev = _cuda()
    from repro_torch.models import moe
    cfg, cpu, card, x = _moe_case(arch, "float32", dev)
    xs = (x.clone().requires_grad_(), x.to(dev).requires_grad_())
    outs = []
    for m, xx in zip((cpu, card), xs):
        r = moe.route(m.router, cfg, xx.detach().reshape(-1, cfg.d_model))
        for t in m.parameters():
            t.requires_grad_(True)
        y, aux = moe.moe_mlp(m, cfg, xx)
        dy = torch.linspace(-1, 1, y.numel()).view(y.shape).to(y.device)
        grads = torch.autograd.grad((y * dy).sum() + aux,
                                    [xx, *m.parameters()])
        outs.append((r, y.detach(), aux.detach(), grads))
    (rc, yc, ac, gc), (rg, yg, ag, gg) = outs
    assert int((~rc.keep).sum()) > 0
    for f in ("top_e", "slot", "keep"):
        assert torch.equal(getattr(rg, f).cpu(), getattr(rc, f)), f
    np.testing.assert_allclose(yg.cpu(), yc, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(ag), float(ac), rtol=1e-4, atol=1e-4)
    for a, b in zip(gg, gc):
        np.testing.assert_allclose(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_moe_gradient_launches_are_bitwise_alike_under_deterministic_mode():
    """Reduced deepseek-v2-lite's MoE layer in bf16 (shared experts, tokens
    dropped) under PyTorch's deterministic algorithms: no operation of
    the dispatch, the combine or their backward raises, and two forward
    and backward passes give the same bits."""
    dev = _cuda()
    from repro_torch.launch import train
    from repro_torch.models import moe
    cfg, _, card, x = _moe_case("deepseek-v2-lite-16b", "bfloat16", dev,
                                T=(4, 256))
    for t in card.parameters():
        t.requires_grad_(True)
    x = x.to(dev).requires_grad_()
    runs = []
    with train.deterministic():
        for _ in range(2):
            y, aux = moe.moe_mlp(card, cfg, x)
            runs.append(torch.autograd.grad(y.float().square().sum() + aux,
                                            [x, *card.parameters()]))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the RG-LRU hybrid, the encoder-decoder and the VLM
# ---------------------------------------------------------------------------

# (name, B, H, Hkv, Sq, Sk, dh, causal): recurrentgemma's local attention
# with a vacuous window (MQA 10/1, heads of 256), whisper's encoder (16
# heads of 64 over 1,500 frames, non-causal), its cross-attention at a
# prompt and at decode (Sq != Sk, non-causal), pixtral's GQA 32/8 at
# heads of 128 over patch rows and text; batch and length cut
NEW_FLASH = [("local", 2, 10, 1, 512, 512, 256, True),
             ("encoder", 2, 16, 16, 1500, 1500, 64, False),
             ("cross", 2, 16, 16, 448, 1500, 64, False),
             ("cross_decode", 2, 16, 16, 1, 1500, 64, False),
             ("pixtral", 1, 32, 8, 1024, 1024, 128, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", NEW_FLASH, ids=[c[0] for c in NEW_FLASH])
def test_flash_kernels_at_the_new_families_shapes(case):
    """The flash forward (bf16, tensor cores) and its gradient against
    their plain versions at each new path's shape family; the gradient
    also bitwise on a second launch."""
    dev = _cuda()
    _, B, H, Hkv, Sq, Sk, dh, causal = case
    a = _bwd_case(Sq + dh, B, H, Hkv, Sq, Sk, dh, torch.bfloat16, dev,
                  causal)
    q, k, v = a[:3]
    before = dict(kfa.flash_attention_cuda.launches_by_design)
    got = kfa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = kfa.flash_attention_cuda.launches_by_design
    assert after["tensor_core"] == before["tensor_core"] + 1
    _attn_close(got, ref.attention_ref(q, k, v, causal=causal))
    before = dict(kfa.flash_attention_bwd_cuda.launches_by_design)
    one = kfa.flash_attention_bwd_cuda(*a, causal=causal)
    two = kfa.flash_attention_bwd_cuda(*a, causal=causal)
    torch.cuda.synchronize()
    after = kfa.flash_attention_bwd_cuda.launches_by_design
    assert after["tensor_core"] == before["tensor_core"] + 2
    for g1, g2 in zip(one, two):
        assert torch.equal(g1, g2)
    _bwd_close(one, ref.flash_attention_bwd_ref(*a, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,offset,window", [
    (64, 64, 0, 64),          # vacuous: the kernel
    (300, 300, 0, 128),       # the window masks: einsum
    (3, 2100, 2097, 128),     # an offset past the window: chunked
    (1, 300, 299, 128)])      # decode's row
def test_windowed_sdpa_on_the_card_equals_the_cpu(dtype, Sq, Sk, offset,
                                                  window):
    """``sdpa`` with a window on the card (the flash kernel where the
    window masks nothing, else the plain windowed paths, products over
    the bf16 operands) against the CPU's, MQA at heads of 256, within the
    flash tolerance (2e-5 float32, 0.05 bf16)."""
    dev = _cuda()
    from repro_torch.models import attention as attn
    q, k, v = _attn(Sq + Sk, 2, 4, 1, Sq, Sk, 256, dtype, "cpu")
    want = attn.sdpa(q, k, v, causal=True, window=window, q_offset=offset)
    before = kfa.flash_attention_cuda.launches
    got = attn.sdpa(q.to(dev), k.to(dev), v.to(dev), causal=True,
                    window=window, q_offset=offset)
    torch.cuda.synchronize()
    launched = kfa.flash_attention_cuda.launches - before
    assert launched == (1 if offset == 0 and Sq - 1 < window else 0)
    _attn_close(got.cpu(), want)


@pytest.mark.gpu
def test_rglru_block_bf16_on_the_card_equals_the_cpu():
    """An RG-LRU block at recurrentgemma-2b's published width (d = w =
    2,560) in bf16, lam float32, 4 x 300 tokens, with and without a
    carried state: the card against the CPU (the same bf16 products and
    float32 gates and scan), every output within 0.05 of the CPU's
    largest |out|, the state's h within 1e-3 of its largest |h|."""
    dev = _cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import rglru
    cfg = get_config("recurrentgemma-2b")
    cpu = rglru.RGLRU(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for module in cpu.modules():            # the conv resets itself
        module.reset_parameters(gen)
    card = rglru.RGLRU(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    assert card.lam.dtype == torch.float32
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 300, cfg.d_model), generator=g).bfloat16()
    st = rglru.init_rglru_state(cfg, 4, "cpu")
    st["h"].normal_(generator=g)
    for state in (None, st):
        with torch.no_grad():
            want = rglru.rglru_block(cpu, cfg, x, state=state)
            got = rglru.rglru_block(card, cfg, x.to(dev), state=None if
                                    state is None else {
                                        k: t.to(dev) for k, t in state.items()})
        torch.cuda.synchronize()
        if state is None:
            want, got = (want, None), (got, None)
        scale = float(want[0].float().abs().max())
        np.testing.assert_allclose(got[0].float().cpu(), want[0].float(),
                                   rtol=0.05, atol=0.05 * scale)
        if state is not None:
            hs = float(want[1]["h"].abs().max())
            np.testing.assert_allclose(got[1]["h"].cpu(), want[1]["h"],
                                       rtol=1e-3, atol=1e-3 * hs)
