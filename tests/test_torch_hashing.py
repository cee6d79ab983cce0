"""The port's hash families and offsets against the JAX reference.

Sampled parameters: b, beta, pack_mult and pack_add (uniform / randint
draws) BITWISE equal; A and alpha (normal draws) within 2 ulp, alpha_cauchy
(tan of a uniform) within 4 ulp.  With the reference's parameters carried
across by ``convert.py``, the integer outputs -- H buckets, packed words,
Keys, shard ids -- are EQUAL for every Scheme and T in {1, 2, 4}, and the
query offsets agree within 1e-6 (the normal draws' 2 ulp through a norm).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import config as jconfig, hashing as jh  # noqa: E402
from repro.core import offsets as joff  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import config, hashing as th  # noqa: E402
from repro_torch.core import offsets as toff, prng  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

FIELDS = convert.FIELDS


def _cfgs(scheme, T, d=32, k=8):
    kw = dict(d=d, k=k, W=1.2, r=0.3, c=2.0, L=8, n_shards=8, seed=0,
              n_tables=T)
    return (jconfig.LSHConfig(scheme=jconfig.Scheme(scheme), **kw),
            config.LSHConfig(scheme=config.Scheme(scheme), **kw))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b).max(initial=0)


@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 7])
def test_sampled_params_match(T, seed):
    jcfg, tcfg = _cfgs("layered", T)
    jk = jax.random.split(jax.random.PRNGKey(seed))[0]
    tk = prng.split(prng.PRNGKey(seed))[0]
    jp = jh.sample_stacked_params(jk, jcfg)
    tp = th.sample_stacked_params(tk, tcfg)
    for name in ("b", "beta"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jp, name)).view(np.uint32),
            getattr(tp, name).numpy().view(np.uint32))
    for name in ("pack_mult", "pack_add"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jp, name)).astype(np.int64),
            getattr(tp, name).numpy())
    assert _ulps(jp.A, tp.A) <= 2 and _ulps(jp.alpha, tp.alpha) <= 2
    assert _ulps(jp.alpha_cauchy, tp.alpha_cauchy) <= 4


def _carried(jcfg, T, seed=0):
    jp = jh.sample_stacked_params(jax.random.PRNGKey(seed), jcfg)
    arrays = {f: np.asarray(getattr(jp, f)) for f in FIELDS}
    return jp, convert.stacked_params_from_arrays(arrays)


@pytest.mark.parametrize("scheme", ["simple", "layered", "sum", "cauchy"])
@pytest.mark.parametrize("T", [1, 2, 4])
def test_hash_pack_key_equal_with_carried_params(scheme, T):
    jcfg, tcfg = _cfgs(scheme, T)
    jp, tp = _carried(jcfg, T)
    rng = np.random.default_rng(T)
    x = (rng.standard_normal((300, 32)) / np.sqrt(32)).astype(np.float32)
    for t in range(T):
        jpt, tpt = jp.table(t), tp.table(t)
        jhk = jh.hash_h(jpt, jnp.asarray(x), jcfg.W)
        thk = th.hash_h(tpt, torch.from_numpy(x), tcfg.W)
        np.testing.assert_array_equal(np.asarray(jhk), thk.numpy())
        np.testing.assert_array_equal(
            np.asarray(jh.pack_buckets(jpt, jhk)).view(np.int32),
            th.pack_buckets(tpt, thk).numpy())
        np.testing.assert_array_equal(
            np.asarray(jh.shard_key(jpt, jcfg, jhk)),
            th.shard_key(tpt, tcfg, thk).numpy())
        np.testing.assert_array_equal(
            np.asarray(jh.shard_of(jpt, jcfg, jhk)),
            th.shard_of(tpt, tcfg, thk).numpy())
    # the stacked (T, ...) form hashes every table at once, table t equal
    # to the per-table call bit for bit
    stacked = th.hash_h(tp, torch.from_numpy(x), tcfg.W)
    for t in range(T):
        np.testing.assert_array_equal(
            stacked[t].numpy(), th.hash_h(tp.table(t), torch.from_numpy(x),
                                          tcfg.W).numpy())


def test_pack_wraps_in_uint32():
    """Large and negative bucket coordinates wrap exactly as uint32."""
    jcfg, tcfg = _cfgs("simple", 1)
    jp, tp = _carried(jcfg, 1)
    hk = np.array([[2 ** 31 - 1, -2 ** 31, -1, 0, 123456789, -987654321,
                    7, -7]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jh.pack_buckets(jp.table(0), jnp.asarray(hk))).view(
            np.int32),
        th.pack_buckets(tp.table(0), torch.from_numpy(hk)).numpy())


@pytest.mark.parametrize("T", [1, 2])
def test_query_offsets_by_table(T):
    jcfg, tcfg = _cfgs("layered", T)
    jkeys = joff.stacked_base_keys(jax.random.PRNGKey(5), T)
    tkeys = convert.keys_from_array(np.asarray(jkeys))
    np.testing.assert_array_equal(
        toff.stacked_base_keys(prng.PRNGKey(5), T).numpy(), tkeys.numpy())
    rng = np.random.default_rng(1)
    R, L, d = 24, 8, 32
    qs = rng.standard_normal((R, d)).astype(np.float32)
    tabs = rng.integers(0, T, R).astype(np.int32)
    qids = rng.integers(0, 1000, R).astype(np.int32)
    want = joff.query_offsets_by_table(jkeys, jnp.asarray(tabs),
                                       jnp.asarray(qids), jnp.asarray(qs),
                                       L, 0.3)
    got = toff.query_offsets_by_table(tkeys, torch.from_numpy(tabs),
                                      torch.from_numpy(qids),
                                      torch.from_numpy(qs), L, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("scheme", ["simple", "layered", "sum", "cauchy"])
def test_gh_equal_with_carried_params(scheme):
    """GH(x) = shard_key(H(x)): the Keys equal for every scheme."""
    jcfg, tcfg = _cfgs(scheme, 2)
    jp, tp = _carried(jcfg, 2)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((200, 32)) / np.sqrt(32)).astype(np.float32)
    for t in range(2):
        np.testing.assert_array_equal(
            th.gh(tp.table(t), tcfg, torch.from_numpy(x)).numpy(),
            np.asarray(jh.gh(jp.table(t), jcfg, jnp.asarray(x))))


@pytest.mark.parametrize("T", [1, 3])
def test_table_params_and_keys_are_the_stacked_rows(T):
    """sample_table_params entry t and table_base_key(key, t) are row t of
    the stacked forms; the offsets of batch_query_offsets are the
    reference's within 1e-6, table 1's too."""
    _, tcfg = _cfgs("layered", T)
    key = prng.split(prng.PRNGKey(3))[0]
    tables = th.sample_table_params(key, tcfg)
    stacked = th.sample_stacked_params(key, tcfg)
    assert len(tables) == T
    for t, p in enumerate(tables):
        for f in FIELDS:
            assert torch.equal(getattr(p, f), getattr(stacked.table(t), f))
        assert torch.equal(toff.table_base_key(key, t),
                           toff.stacked_base_keys(key, T)[t])
    jkey = jax.random.split(jax.random.PRNGKey(3))[0]
    rng = np.random.default_rng(T)
    qs = rng.standard_normal((12, 32)).astype(np.float32)
    for t in range(min(T, 2)):
        want = joff.batch_query_offsets(
            joff.table_base_key(jkey, t), jnp.arange(12, dtype=jnp.int32),
            jnp.asarray(qs), 8, 0.3)
        got = toff.batch_query_offsets(
            toff.table_base_key(key, t), torch.arange(12, dtype=torch.int32),
            torch.from_numpy(qs), 8, 0.3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
