"""The port's Multi-Probe LSH against the JAX reference, on the CPU.

With the reference's sampled parameters carried across (``convert.py``),
``batch_mplsh_probes`` gives the reference's probes EQUAL, row for row,
at n_probes in {4, 20, 60}: 60 passes the 2k + C(8, 2) = 48 candidates
of k = 10, so the tail is SENTINEL padding and ``probe_valid_mask``
drops it.  A crafted query whose Gamma has tied fractional parts (tied
single scores, tied pair sums, same-coordinate pairs taken at inf) holds
the tie order: the lower candidate index first, as ``jax.lax.top_k``.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import config as jconfig, hashing as jh  # noqa: E402
from repro.core import multiprobe as jmp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import multiprobe as tmp  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

D = 50


def _cfgs(k=10, W=1.2):
    kw = dict(d=D, k=k, W=W, r=0.3, c=2.0, L=16, n_shards=8, seed=0,
              probes="mplsh")
    return (jconfig.LSHConfig(scheme=jconfig.Scheme.LAYERED, **kw),
            tconfig.LSHConfig(scheme=tconfig.Scheme.LAYERED, **kw))


def _carried(jp):
    return convert.stacked_params_from_arrays(
        {f: np.asarray(getattr(jp, f))[None] for f in convert.FIELDS}
    ).table(0)


def _queries(m=128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, D)) / np.sqrt(D)).astype(np.float32)


@pytest.mark.parametrize("n_probes", [4, 20, 60])
def test_probes_match_reference(n_probes):
    jcfg, tcfg = _cfgs()
    jp = jh.sample_params(jax.random.PRNGKey(0), jcfg)
    q = _queries()
    want = np.asarray(jmp.batch_mplsh_probes(jp, jcfg, jnp.asarray(q),
                                             n_probes))
    got = tmp.batch_mplsh_probes(_carried(jp), tcfg, torch.from_numpy(q),
                                 n_probes)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    valid = tmp.probe_valid_mask(got).numpy()
    np.testing.assert_array_equal(valid,
                                  np.asarray(jmp.probe_valid_mask(want)))
    assert valid.sum(1).max() == min(n_probes, 48) + 1
    assert tmp.SENTINEL == jmp.SENTINEL and tmp.PAIR_POOL == jmp.PAIR_POOL


def test_one_query_is_a_row_of_the_batch():
    jcfg, tcfg = _cfgs()
    tp = _carried(jh.sample_params(jax.random.PRNGKey(1), jcfg))
    q = torch.from_numpy(_queries(8, seed=1))
    batch = tmp.batch_mplsh_probes(tp, tcfg, q, 20)
    for i in range(len(q)):
        assert torch.equal(tmp.mplsh_probes(tp, tcfg, q[i], 20), batch[i])


B_TIED = {
    # fractional parts 0.25 (three coords), 0.75 (two: their shift +1
    # ties the 0.25 shifts -1), 0.5 and 0 repeat: singles and pairs tie
    10: [0.25, 0.75, 0.25, 0.5, 1.0, 0.25, 0.75, 1.5, 0.5, 0.0],
    # 2k = PAIR_POOL: both shifts of every coordinate are in the pool, so
    # 4 of the 28 pairs touch one coordinate twice and score inf
    4: [0.25, 0.75, 0.5, 0.0],
}


@pytest.mark.parametrize("k,n_probes", [(10, 12), (10, 60), (4, 20),
                                        (4, 60)])
def test_tied_scores_keep_the_reference_order(k, n_probes):
    """x = 0, so Gamma = b / W exactly in both packages."""
    W = 1.0
    jcfg, tcfg = _cfgs(k=k, W=W)
    b = np.array(B_TIED[k], np.float32)
    rng = np.random.default_rng(4)
    A = rng.standard_normal((D, k)).astype(np.float32)
    jp = dataclasses.replace(jh.sample_params(jax.random.PRNGKey(2), jcfg),
                             A=jnp.asarray(A), b=jnp.asarray(b))
    q = np.zeros((3, D), np.float32)
    want = np.asarray(jmp.batch_mplsh_probes(jp, jcfg, jnp.asarray(q),
                                             n_probes))
    got = tmp.batch_mplsh_probes(_carried(jp), tcfg, torch.from_numpy(q),
                                 n_probes)
    np.testing.assert_array_equal(got.numpy(), want)
    # past the 8 singles and 24 finite pairs of k = 4 the inf-scored
    # same-coordinate pairs are taken: a -1 and a +1 on one coordinate
    # repeat the home bucket (reference behaviour, kept)
    repeats = (want[0, 1:] == want[0, 0]).all(axis=1).sum()
    assert repeats == (4 if (k, n_probes) == (4, 60) else 0)
