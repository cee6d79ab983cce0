"""The port's threefry2x32 generator against ``jax.random``.

Keys, split, fold_in chains, raw bits, uniform and randint must be
BITWISE equal.  normal (sqrt(2) * erfinv(u)) must lie within 2 ulp of
jax's everywhere and be bitwise equal on at least 99.99% of draws (the
port evaluates erfinv the way XLA's CPU backend does; a handful of draws
in a million round an ulp apart).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

SEEDS = [0, 1, 42, 2 ** 31 - 1]
SHAPES = [(), (5,), (3, 4), (7, 33)]


def _np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_chains(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    for _ in range(3):                  # split -> fold_in -> split chain
        np.testing.assert_array_equal(_np(jax.random.split(jk, 7)),
                                      prng.split(tk, 7).numpy())
        jk = jax.random.fold_in(jax.random.split(jk)[1], 12345)
        tk = prng.fold_in(prng.split(tk)[1], 12345)
        np.testing.assert_array_equal(_np(jk), tk.numpy())


def test_batched_fold_in_equals_per_row():
    jk = jax.random.PRNGKey(3)
    data = np.array([0, 1, 77, 2 ** 31 - 1, 2 ** 32 - 1], np.int64)
    got = prng.fold_in(prng.PRNGKey(3), torch.as_tensor(data))
    for i, v in enumerate(data):
        want = jax.random.fold_in(jk, np.uint32(v))
        np.testing.assert_array_equal(_np(want), got[i].numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_randint_bitwise(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jax.random.bits(jk, shape)),
                                  prng.random_bits(tk, shape).numpy())
    ju = np.asarray(jax.random.uniform(jk, shape, maxval=1.2))
    tu = prng.uniform(tk, shape, 0.0, 1.2).numpy()
    np.testing.assert_array_equal(ju.view(np.uint32), tu.view(np.uint32))
    ju = np.asarray(jax.random.uniform(jk, shape, minval=1e-6,
                                       maxval=1.0 - 1e-6))
    tu = prng.uniform(tk, shape, 1e-6, 1.0 - 1e-6).numpy()
    np.testing.assert_array_equal(ju.view(np.uint32), tu.view(np.uint32))
    for lo, hi in [(0, 2 ** 31 - 1), (-5, 17), (0, 3)]:
        ji = np.asarray(jax.random.randint(jk, shape, lo, hi,
                                           dtype=jnp.int32))
        np.testing.assert_array_equal(ji, prng.randint(tk, shape, lo,
                                                       hi).numpy())


def test_batched_keys_draw_like_single_keys():
    keys = prng.split(prng.PRNGKey(9), 4)
    batched = prng.normal(keys, (3, 5))
    for i in range(4):
        np.testing.assert_array_equal(
            batched[i].numpy().view(np.uint32),
            prng.normal(keys[i], (3, 5)).numpy().view(np.uint32))


@pytest.mark.parametrize("seed", [3, 11])
def test_normal_within_2ulp_and_mostly_bitwise(seed):
    shape = (1 << 18,)
    jn = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                      jnp.float32))
    tn = prng.normal(prng.PRNGKey(seed), shape).numpy()
    ulp = np.abs(jn.view(np.int32).astype(np.int64)
                 - tn.view(np.int32).astype(np.int64))
    assert ulp.max() <= 2
    assert np.mean(ulp == 0) >= 0.9999


def test_erfinv_edges():
    x = torch.tensor([-1.0, 0.0, 1.0, 0.5, -0.999999])
    got = prng.erfinv(x).numpy()
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x.numpy())))
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[2])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_mul_u32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    b = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    want = (a.astype(np.uint32) * b.astype(np.uint32)).astype(np.int64)
    got = prng.mul_u32(torch.as_tensor(a.astype(np.int64)),
                       torch.as_tensor(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
