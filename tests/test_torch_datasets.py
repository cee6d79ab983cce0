"""The port's datasets and dedup pre-pass against the JAX reference.

``planted_random`` draws through the port's jax-compatible PRNG: data
and queries within 2 ulp of the reference's (normal draws, then the same
float32 scale and add), the planted ids BITWISE (``randint`` below and
above a span of 2**16).  ``tfidf_like`` and ``image_histograms`` are the
reference's numpy code: BITWISE.  ``dedup_embeddings`` hashes with the
port's ``sample_params``/``hash_h``/``pack_buckets``: the keep-mask
EQUAL, on data with near-duplicates planted.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.data import datasets as jds, dedup as jdd  # noqa: E402
from repro_torch.data import datasets as tds, dedup as tdd  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b).max(initial=0)


@pytest.mark.parametrize("n,m,d,seed", [(4096, 256, 50, 0),
                                        (4096, 256, 100, 3),
                                        (100_000, 64, 4, 1)])
def test_planted_random_matches_reference(n, m, d, seed):
    wd, wq, wi = jds.planted_random(n, m, d=d, r=0.3, seed=seed)
    gd, gq, gi = tds.planted_random(n, m, d=d, r=0.3, seed=seed,
                                    device="cpu")
    assert gd.dtype == gq.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), wi)
    assert _ulps(gd.numpy(), wd) <= 2
    assert _ulps(gq.numpy(), wq) <= 2


@pytest.mark.parametrize("n,m,d", [(300, 40, 256), (50, 7, 16)])
def test_tfidf_like_matches_reference(n, m, d):
    for want, got in zip(jds.tfidf_like(n, m, d=d, seed=4),
                         tds.tfidf_like(n, m, d=d, seed=4)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m,d", [(300, 40, 64), (50, 7, 8)])
def test_image_histograms_matches_reference(n, m, d):
    for want, got in zip(jds.image_histograms(n, m, d=d, seed=5),
                         tds.image_histograms(n, m, d=d, seed=5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r,k", [(0.3, 12), (0.05, 4)])
def test_dedup_embeddings_matches_reference(r, k):
    rng = np.random.default_rng(6)
    d = 32
    base = (rng.standard_normal((2000, d)) / np.sqrt(d)).astype(np.float32)
    near = base[rng.integers(0, 2000, 400)] + (
        rng.standard_normal((400, d)) * (0.2 * r / np.sqrt(d))
    ).astype(np.float32)
    emb = np.concatenate([base, near]).astype(np.float32)
    want = jdd.dedup_embeddings(emb, r=r, k=k)
    got = tdd.dedup_embeddings(emb, r=r, k=k, device="cpu")
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert 0 < (~got).sum() <= 400
    np.testing.assert_array_equal(
        tdd.dedup_embeddings(torch.from_numpy(emb), r=r, k=k,
                             device="cpu"), want)
