"""The hash kernel's summation order, its plan and its plain version, on
the CPU.

``csrc/lsh_hash.cu`` cannot run here, so its order is emulated in numpy:
chunk sums of ``chunk`` consecutive products, merged as they arrive by a
binary counter and folded from the right with one ``+ 0.0`` per missing
level.  It must be BITWISE ``tree_sum`` (the order of ``hash_h``) at
every width, signed zeros included, for the chunk ``plan`` picks and
every smaller power of two.  ``plan`` must size the index's and the
retrieval paths' shapes and refuse what the kernel does not take, and
``hash_h`` on the CPU must equal ``ref.lsh_hash_ref`` column for column,
under stacked and per-row tables.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import LSHConfig, Scheme, hashing as th, prng
from repro_torch.kernels import lsh_hash as klh
from repro_torch.kernels import ref
from repro_torch.kernels.types import tree_sum
from test_torch_cuda import one_torch_thread  # noqa: F401

WIDTHS = [1, 3, 5, 64, 96, 100, 768, 3072]


def kernel_order_sum(p: np.ndarray, chunk: int) -> np.ndarray:
    """(rows, d) float32 products -> (rows,) summed as the kernel sums."""
    d = p.shape[1]
    P = d // chunk
    stack = [None] * klh.LEVELS
    for ch in range(P):
        v = p[:, ch * chunk:(ch + 1) * chunk]
        while v.shape[1] > 1:                 # the chunk's pairwise tree
            v = v[:, 0::2] + v[:, 1::2]
        v = v[:, 0]
        level = 0
        while (ch >> level) & 1:              # the counter's carries
            v = stack[level] + v
            level += 1
        stack[level] = v
    zero, have = np.float32(0.0), False
    for level in range(klh.LEVELS):           # the fold from the right
        bit = (P >> level) & 1
        if not have:
            if bit:
                v, have = stack[level], True
                if P >> (level + 1):
                    v = v + zero
        elif P >> level:
            v = stack[level] + v if bit else v + zero
    return v


def _products(d, rows=64, seed=0):
    rng = np.random.default_rng(seed + d)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    a = rng.standard_normal(d).astype(np.float32)
    x[0] = 0.0                                # +0 products
    x[1] = -0.0
    x[2, :] = np.float32(1e-30)               # subnormal products
    a[: max(1, d // 3)] *= np.float32(-1.0)
    p = x * a
    p[3] = -0.0                               # an all -0.0 row
    p[4] = np.float32(-0.0)
    p[4, -1] = np.float32(0.0)
    return p


def _bits(v):
    return np.asarray(v, np.float32).view(np.uint32)


@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_order_is_bitwise_tree_sum(d):
    p = _products(d)
    want = tree_sum(torch.from_numpy(p), -1).numpy()
    chunk = klh.plan(1000, d, 8).chunk
    j = (d & -d).bit_length() - 1
    assert chunk == 1 << min(j, klh.MAX_CHUNK_LOG)
    c = chunk
    while c >= 1:                             # any power of 2 <= the plan's
        np.testing.assert_array_equal(_bits(kernel_order_sum(p, c)),
                                      _bits(want), err_msg=f"chunk {c}")
        c //= 2
    # the all -0.0 row: -0.0 where d is a power of two, else +0.0 (padded)
    assert _bits(want[3]) == _bits(np.float32(-0.0 if d & (d - 1) == 0
                                              else 0.0))


def test_a_plain_ascending_sum_is_not_tree_sum():
    """The order matters: an ascending chain differs in many rows."""
    p = _products(768, rows=512)
    want = _bits(tree_sum(torch.from_numpy(p), -1).numpy())
    chain = np.zeros(p.shape[0], np.float32)
    for i in range(p.shape[1]):
        chain = chain + p[:, i]
    assert np.mean(_bits(chain) == want) < 0.9


@pytest.mark.parametrize("name,n,d,K,T,dtype", [
    ("index insert", 1 << 22, 64, 20, 1, torch.float32),
    ("index dispatch", 2 * 1024, 64, 10, 2, torch.float32),
    ("index receive", 8 * 100 * 16, 64, 10, 2, torch.float32),
    ("index G", 2 * (1 << 22), 10, 1, 2, torch.int32),
    ("gemma-7b receive", 8 * 24 * 16, 3072, 8, 1, torch.float32),
    ("mamba2-130m receive", 8 * 160 * 16, 768, 8, 1, torch.float32),
    ("retrieval G", 8 * 24 * 16, 8, 1, 1, torch.int32),
    ("bf16 wide", 300, 3072, 33, 4, torch.bfloat16),
    ("many columns", 100, 64, 600, 1, torch.float32),
])
def test_plan_takes_the_main_paths_shapes(name, n, d, K, T, dtype):
    p = klh.plan(n, d, K, T=T, dtype=dtype, vec=dtype == torch.float32)
    j = (d & -d).bit_length() - 1
    top = 1 << min(j, klh.MAX_CHUNK_LOG)
    if "receive" in name or "index" in name or "G" in name:
        assert p.chunk == top, name           # the paths' shapes: no halving
    assert top % p.chunk == 0 and p.chunk & (p.chunk - 1) == 0
    assert p.chunks * p.chunk == d and p.chunks < 2 ** klh.LEVELS
    assert p.col_block == min(K, 8 * klh.MAX_COLS)
    assert p.col_blocks * p.col_block >= K
    assert p.col_groups in (1, 2, 4, 8) and p.cols in klh.COLS
    assert p.cols * p.col_groups >= p.col_block
    per = klh.ROWS if p.chunks == 1 else 1
    assert p.rows == 32 * per * (8 // p.col_groups)
    assert p.opitch % 2 == 1 and p.opitch >= p.col_block
    assert p.stages in (2, 3) and p.smem_bytes <= klh.SMEM_LIMIT
    assert p.smem_bytes == klh.smem_bytes(T, K, p.col_block, p.rows,
                                          p.pitch, p.apitch, p.opitch,
                                          p.stages, p.a_resident, T > 1)
    ds = p.stage_chunks * p.chunk
    assert p.chunks % p.stage_chunks == 0
    assert ds <= max(p.chunk, klh.MAX_STAGE)
    assert p.a_resident == (p.chunks == p.stage_chunks
                            and p.col_blocks == 1)
    assert p.vec == (dtype == torch.float32 and p.chunk % 4 == 0)
    for pitch in (p.pitch, p.apitch):         # what the C side accepts
        assert pitch >= ds
        assert pitch % 8 == 4 if p.chunk >= 4 else pitch % 2 == 1


def test_plan_at_the_index_shape_keeps_two_blocks():
    p = klh.plan(1 << 22, 64, 20, vec=True)
    assert (p.chunk, p.chunks, p.stages, p.a_resident, p.vec) == (
        64, 1, 2, True, True)
    assert (p.col_groups, p.cols, p.rows, p.pitch) == (4, 5, 128, 68)
    assert p.smem_bytes <= klh.SMEM_TWO


@pytest.mark.parametrize("d,chunk,stage_chunks", [
    (10, 2, 5), (100, 4, 5), (3, 1, 3), (768, 64, 1), (96, 32, 1),
    (3072, 64, 1), (1, 1, 1)])
def test_plan_stages_whole_chunks(d, chunk, stage_chunks):
    """The second layer's d = k = 10 takes one stage of five chunks."""
    p = klh.plan(1000, d, 1 if d == 10 else 20, T=2)
    assert (p.chunk, p.stage_chunks) == (chunk, stage_chunks)


@pytest.mark.parametrize("kw,match", [
    (dict(n=10, d=(1 << 16) + 1, K=4), "chunk sums"),
    (dict(n=10, d=64, K=256, T=300), "do not fit"),
    (dict(n=10, d=64, K=0), "positive"),
    (dict(n=10, d=0, K=4), "positive"),
    (dict(n=10, d=64, K=4, T=0), "positive"),
    (dict(n=10, d=64, K=4, dtype=torch.float64), "float32 or bfloat16"),
])
def test_plan_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        klh.plan(**kw)


def test_plan_halves_the_chunk_for_many_tables():
    """Many tables of wide columns: a's stage shrinks with the chunk."""
    p = klh.plan(100, 64, 256, T=40)
    assert p.chunk < 64 and p.smem_bytes <= klh.SMEM_LIMIT


def _cfg(scheme, T):
    return LSHConfig(d=32, k=8, W=1.2, r=0.3, c=2.0, L=8, n_shards=8,
                     seed=0, n_tables=T, scheme=Scheme(scheme))


def _tree_hash(x, A, b, W):
    """The arithmetic spelled out: products, tree_sum, + b, / W, floor."""
    proj = tree_sum(x[..., :, :, None] * A[..., None, :, :], -2)
    q = (proj + b.unsqueeze(-2)) / torch.tensor(W, dtype=torch.float32)
    return torch.floor(q).to(torch.int32)


@pytest.mark.parametrize("T", [1, 2, 4])
def test_hash_h_equals_the_plain_version_per_table(T):
    cfg = _cfg("layered", T)
    sp = th.sample_stacked_params(prng.PRNGKey(3), cfg)
    x = torch.from_numpy((np.random.default_rng(T).standard_normal(
        (500, 32)) / np.sqrt(32)).astype(np.float32))
    stacked = th.hash_h(sp, x, cfg.W)                  # tables side by side
    assert stacked.shape == (T, 500, 8)
    for t in range(T):
        want = ref.lsh_hash_ref(x, sp.A[t], sp.b[t], w=cfg.W)
        np.testing.assert_array_equal(stacked[t].numpy(), want.numpy())
        np.testing.assert_array_equal(
            want.numpy(), _tree_hash(x, sp.A[t], sp.b[t], cfg.W).numpy())
    # x (T, N, d): table t on x[t]
    xt = x[: 120 * T].reshape(T, 120, 32)
    lead = th.hash_h(sp, xt, cfg.W)
    for t in range(T):
        np.testing.assert_array_equal(
            lead[t].numpy(),
            ref.lsh_hash_ref(xt[t], sp.A[t], sp.b[t], w=cfg.W).numpy())
    # Gamma's quotient floors to H
    g = th.gamma(sp, x, cfg.W)
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(torch.floor(g).to(torch.int32).numpy(),
                                  stacked.numpy())


@pytest.mark.parametrize("scheme", ["simple", "layered", "sum", "cauchy"])
@pytest.mark.parametrize("T", [1, 2, 4])
def test_per_row_tables_equal_gathered_params(scheme, T):
    """The receive side's table ids give what gathering each row's
    parameters gives: H, packed words and Keys, bit for bit."""
    cfg = _cfg(scheme, T)
    sp = th.sample_stacked_params(prng.PRNGKey(5), cfg)
    rng = np.random.default_rng(T)
    S, R, L = 3, 7, 4
    offs = torch.from_numpy((rng.standard_normal((S, R, L, 32))
                             / np.sqrt(32)).astype(np.float32))
    tab = torch.from_numpy(rng.integers(0, T, (S, R)).astype(np.int32))
    hk = th.hash_h(sp, offs, cfg.W, tab)
    gp = sp.gather(tab.long())
    np.testing.assert_array_equal(hk.numpy(),
                                  th.hash_h(gp, offs, cfg.W).numpy())
    np.testing.assert_array_equal(
        hk.numpy(), ref.lsh_hash_ref(offs, sp.A, sp.b, w=cfg.W,
                                     table=tab).numpy())
    np.testing.assert_array_equal(
        th.pack_buckets(sp, hk, tab).numpy(),
        th.pack_buckets(gp, hk).numpy())
    np.testing.assert_array_equal(
        th.shard_key(sp, cfg, hk, tab).numpy(),
        th.shard_key(gp, cfg, hk).numpy())
    np.testing.assert_array_equal(
        th.shard_of(sp, cfg, hk, tab).numpy(),
        th.shard_of(gp, cfg, hk).numpy())


def test_second_layer_takes_int_buckets_exactly():
    """G reads the int32 bucket vectors as hk.to(float32) does."""
    cfg = _cfg("layered", 2)
    sp = th.sample_stacked_params(prng.PRNGKey(7), cfg)
    hk = torch.from_numpy(np.random.default_rng(0).integers(
        -2 ** 26, 2 ** 26, (2, 300, 8)).astype(np.int32))
    got = th.g_of(sp, hk, float(cfg.D))
    for t in range(2):
        want = _tree_hash(hk[t].to(torch.float32), sp.alpha[t][:, None],
                          sp.beta[t][None], float(cfg.D))[:, 0]
        np.testing.assert_array_equal(got[t].numpy(), want.numpy())


def test_wrapper_refuses_mismatched_tables():
    x = torch.zeros((4, 5, 8))
    a, b = torch.zeros((2, 8, 3)), torch.zeros((2, 3))
    with pytest.raises(ValueError, match="cover x's leading dims"):
        klh.lsh_hash_cuda(x, a, b, w=1.0, table=torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="lead with the T = 2 tables"):
        klh.lsh_hash_cuda(x, a, b, w=1.0)
    with pytest.raises(ValueError, match="stacked"):
        klh.lsh_hash_cuda(x, a[0], b[0], w=1.0,
                          table=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="integers"):
        klh.lsh_hash_cuda(x, a, b, w=1.0, table=torch.zeros(4))
    assert klh.lsh_hash_cuda(x[:2], a, b, w=1.0).shape == (2, 5, 3)
