"""The port's brute-force oracle against the JAX reference, on the CPU.

``nearest_neighbor``, ``nearest_neighbors``, ``topk_sort`` (the
counterpart of ``topk_sort_jnp``) and ``topk_merge_host`` on the same
seeded numpy inputs, with exact ties: duplicated points (equal distances
inside a chunk and across chunk edges) and tied (dist, id) candidates.
Tolerance: ids EQUAL (ties go to the lower id, as in the reference),
distances within rtol = atol = 1e-5 (both take q.p from a float32
product, summed in each library's own order); the sorts of given
distances BITWISE.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import ref_search as jrs  # noqa: E402
from repro_torch.core import ref_search as trs  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)
IMAX = np.iinfo(np.int32).max


def _points(n, m, d, seed=0):
    """Points N(0, 1/d) as the datasets draw them, every one repeated once
    (rows 2i and 2i+1 equal, so a chunk of odd size splits a pair), and
    queries near some of them."""
    rng = np.random.default_rng(seed)
    half = (rng.standard_normal((n // 2, d)) / np.sqrt(d)).astype(np.float32)
    data = np.repeat(half, 2, axis=0)
    q = data[rng.integers(0, n, m)] + np.float32(0.1 / np.sqrt(d)) * (
        rng.standard_normal((m, d)).astype(np.float32))
    return data, q.astype(np.float32)


@pytest.mark.parametrize("chunk", [7, 64, 8192])
def test_nearest_neighbor_matches_reference(chunk):
    data, q = _points(300, 40, 16)
    wd, wi = jrs.nearest_neighbor(data, q, chunk=chunk)
    gd, gi = trs.nearest_neighbor(data, q, chunk=chunk, device="cpu")
    np.testing.assert_array_equal(gi, wi)
    assert np.all(gi % 2 == 0)        # the first of two equal points
    np.testing.assert_allclose(gd, wd, **TOL)


@pytest.mark.parametrize("k,chunk", [(1, 8192), (10, 7), (10, 64),
                                     (25, 33)])
def test_nearest_neighbors_matches_reference(k, chunk):
    data, q = _points(300, 40, 16, seed=1)
    wd, wi = jrs.nearest_neighbors(data, q, k, chunk=chunk)
    gd, gi = trs.nearest_neighbors(data, q, k, chunk=chunk, device="cpu")
    assert gi.dtype == np.int32 and gd.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, **TOL)


def test_nearest_neighbors_pads_a_small_dataset():
    data, q = _points(6, 5, 8, seed=2)
    wd, wi = jrs.nearest_neighbors(data, q, 10)
    gd, gi = trs.nearest_neighbors(data, q, 10, device="cpu")
    np.testing.assert_array_equal(gi, wi)
    assert np.all(gi[:, 6:] == IMAX) and np.all(np.isinf(gd[:, 6:]))
    np.testing.assert_allclose(gd[:, :6], wd[:, :6], **TOL)


def _candidates(m, c, seed):
    """(m, c) distances on a coarse grid (many exact ties), inf-masked
    entries, and distinct ids in a random order."""
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 6, (m, c)) * 0.25).astype(np.float32)
    d[rng.random((m, c)) < 0.2] = np.inf
    g = np.stack([rng.permutation(10 * c)[:c] for _ in range(m)]).astype(
        np.int32)
    g[d == np.inf] = IMAX
    return d, g


@pytest.mark.parametrize("c,k", [(40, 10), (3, 10), (10, 10), (1, 1)])
def test_topk_sort_matches_reference(c, k):
    d, g = _candidates(16, c, seed=c)
    wd, wg = jrs.topk_sort_jnp(jnp.asarray(d), jnp.asarray(g), k)
    gd, gg = trs.topk_sort(torch.from_numpy(d), torch.from_numpy(g), k)
    assert gd.shape == (16, k)
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
    np.testing.assert_array_equal(gd.numpy().view(np.uint32),
                                  np.asarray(wd).view(np.uint32))


def test_topk_sort_pads_with_the_given_distance():
    d, g = _candidates(4, 3, seed=9)
    wd, wg = jrs.topk_sort_jnp(jnp.asarray(d), jnp.asarray(g), 5,
                               pad_d=7.5)
    gd, gg = trs.topk_sort(torch.from_numpy(d), torch.from_numpy(g), 5,
                           pad_d=7.5)
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_merge_host_matches_reference(seed):
    best_d, best_g = _candidates(12, 10, seed)
    order = np.lexsort((best_g, best_d), axis=1)
    best_d = np.take_along_axis(best_d, order, 1)
    best_g = np.take_along_axis(best_g, order, 1)
    cd, cg = _candidates(12, 30, seed + 10)
    cg = np.where(cg == IMAX, IMAX, cg + 1000).astype(np.int32)
    wd, wg = jrs.topk_merge_host(best_d, best_g, cd, cg)
    gd, gg = trs.topk_merge_host(best_d, best_g, cd, cg)
    np.testing.assert_array_equal(gg, wg)
    np.testing.assert_array_equal(gd, wd)


def test_products_stay_ieee_float32():
    """The product is IEEE float32 inside the oracle whatever the process
    set, and the setting is restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with trs.ieee_float32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
