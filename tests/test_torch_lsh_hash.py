"""The port's p-stable hash op against the JAX reference, on the CPU.

``ops.lsh_hash`` on CPU tensors runs the kernel's plain version
(``kernels/ref.lsh_hash_ref``).  The same numpy inputs go through the
reference's ``ops.lsh_hash`` (its Pallas kernel in interpret mode) and
``ref.lsh_hash_ref``.  As in the reference's own test
(``tests/test_kernels.py``), a floor may flip where a projection lands
within float rounding of an integer: agreement >= 0.999 and |diff| <= 1.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.core import DistributedLSHIndex, LSHConfig  # noqa: E402
from repro_torch.core.hashing import hash_h  # noqa: E402
from repro_torch.kernels import lsh_hash as klh  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.int32
    assert np.mean(got == want) >= 0.999, np.mean(got == want)
    assert np.max(np.abs(got.astype(np.int64) - want)) <= 1


def _case(seed, n, d, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    a = rng.standard_normal((d, k)).astype(np.float32)
    b = rng.uniform(0.0, 0.5, k).astype(np.float32)
    return x, a, b


@pytest.mark.parametrize("n,d,k", [(128, 64, 8), (256, 100, 16),
                                   (130, 50, 12), (64, 32, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lsh_hash_matches_reference_and_pallas(n, d, k, dtype):
    x, a, b = _case(n + d + k, n, d, k)
    jx = jnp.asarray(x).astype(dtype)
    pallas = jops.lsh_hash(jx, jnp.asarray(a), jnp.asarray(b), w=0.5)
    plain = jref.lsh_hash_ref(jx, jnp.asarray(a), jnp.asarray(b), w=0.5)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.lsh_hash(tx, torch.from_numpy(a), torch.from_numpy(b), w=0.5)
    _close(got.numpy(), pallas)
    _close(got.numpy(), plain)


def test_lsh_hash_multi_table_packing():
    """K > 128 (many tables at once): the TPU kernel's several lane tiles."""
    x, a, _ = _case(7, 128, 40, 256)
    b = np.zeros(256, np.float32)
    got = ops.lsh_hash(torch.from_numpy(x), torch.from_numpy(a),
                       torch.from_numpy(b), w=1.0)
    _close(got.numpy(), jops.lsh_hash(jnp.asarray(x), jnp.asarray(a),
                                      jnp.asarray(b), w=1.0))
    _close(got.numpy(), jref.lsh_hash_ref(jnp.asarray(x), jnp.asarray(a),
                                          jnp.asarray(b), w=1.0))


def test_lsh_hash_agrees_with_the_index_hash():
    """The index's own projections of two tables side by side: the op
    agrees with ``hash_h`` (its fixed summation tree) within a floor."""
    cfg = LSHConfig(d=64, k=10, W=1.0, r=0.3, c=2.0, L=4, n_shards=2,
                    n_tables=2)
    idx = DistributedLSHIndex(cfg, device="cpu")
    params = idx.stacked_params
    x = torch.from_numpy(_case(3, 3000, 64, 1)[0] / 8.0)
    A = torch.cat([params.table(t).A for t in range(2)], dim=1)
    b = torch.cat([params.table(t).b for t in range(2)])
    got = ops.lsh_hash(x, A, b, w=cfg.W)
    assert got.shape == (3000, 20)
    for t in range(2):
        _close(got[:, 10 * t:10 * (t + 1)].numpy(),
               hash_h(params.table(t), x, cfg.W).numpy())


def test_lsh_hash_wrapper_checks_and_counts_no_cpu_launch():
    x, a, b = map(torch.from_numpy, _case(1, 10, 8, 3))
    before = klh.lsh_hash_cuda.launches
    out = klh.lsh_hash_cuda(x, a, b, w=0.5)
    assert klh.lsh_hash_cuda.launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  ref.lsh_hash_ref(x, a, b, w=0.5).numpy())
    with pytest.raises(ValueError, match="do not match"):
        klh.lsh_hash_cuda(x, a[:7], b, w=0.5)
    with pytest.raises(ValueError, match="float32"):
        klh.lsh_hash_cuda(x, a.double(), b, w=0.5)
    with pytest.raises(ValueError, match="positive"):
        klh.lsh_hash_cuda(x, a, b, w=0.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        klh.lsh_hash_cuda(x.double(), a, b, w=0.5)
