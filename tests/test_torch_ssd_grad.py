"""The SSD scan's gradient on the CPU: the port's plain reverse recurrence
(``ref.ssd_scan_bwd_ref``, what the gradient kernel computes) against
``jax.vjp`` of the reference's sequential scan and against torch
autograd of the port's plain forward; and ``ops.ssd_scan``'s autograd
function, whose backward on CPU tensors is that plain version.

Tolerance: every input's gradient within rtol = atol = 1e-4 (float32
sums of the same terms in another order; the reference's own
chunked-vs-sequential tolerance is 2e-4).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("dx", "db", "dc", "ddt", "da_log")


def _case(seed, B, S, H, G, P, N, mamba_decay=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    if mamba_decay:
        a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    else:
        a_log = rng.uniform(-2.0, 0.5, H).astype(np.float32)
    dy = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    return x, a_log, b, c, dt, dy


def _reference_vjp(x, a_log, b, c, dt, dy):
    """The reference's gradient: jax.vjp of its sequential scan, in the
    order (dx, db, dc, ddt, da_log)."""
    _, vjp = jax.vjp(jref.ssd_scan_ref, *map(jnp.asarray,
                                             (x, a_log, b, c, dt)))
    gx, ga, gb, gc, gdt = vjp(jnp.asarray(dy))
    return [np.asarray(g) for g in (gx, gb, gc, gdt, ga)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("B,S,H,G,P,N,mamba", [
    (2, 70, 4, 1, 8, 16, False),     # one group, S off any chunk
    (1, 45, 4, 2, 16, 8, False),     # two groups
    (2, 33, 4, 2, 8, 8, True),       # mamba2's decay rates (a to -16)
])
def test_ssd_gradient_matches_jax_vjp(B, S, H, G, P, N, mamba):
    x, a_log, b, c, dt, dy = _case(S + H, B, S, H, G, P, N, mamba)
    want = _reference_vjp(x, a_log, b, c, dt, dy)
    got = kssd.ssd_scan_bwd_cuda(*map(_t, (x, a_log, b, c, dt, dy)))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_plain_gradient_is_autograd_of_the_plain_scan():
    x, a_log, b, c, dt, dy = _case(3, 2, 21, 4, 2, 8, 8)
    leaves = [_t(a).requires_grad_() for a in (x, a_log, b, c, dt)]
    y = ref.ssd_scan_ref(*leaves)
    gx, ga, gb, gc, gdt = torch.autograd.grad(y, leaves, _t(dy))
    got = ref.ssd_scan_bwd_ref(*map(_t, (x, a_log, b, c, dt, dy)))
    for name, g, w in zip(NAMES, got, (gx, gb, gc, gdt, ga)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **TOL)


def test_ssd_scan_op_differentiates_through_the_plain_versions():
    """On CPU tensors the autograd function's forward is ssd_scan_ref and
    its backward ssd_scan_bwd_ref, with no kernel launch counted; without
    a gradient it is the plain forward, no graph."""
    x, a_log, b, c, dt, dy = _case(4, 1, 30, 4, 1, 8, 16)
    leaves = [_t(a).requires_grad_() for a in (x, a_log, b, c, dt)]
    before = (kssd.ssd_scan_cuda.launches, kssd.ssd_scan_bwd_cuda.launches)
    y = ops.ssd_scan(*leaves)
    assert y.grad_fn is not None
    y.backward(_t(dy))
    assert (kssd.ssd_scan_cuda.launches,
            kssd.ssd_scan_bwd_cuda.launches) == before
    want = ref.ssd_scan_bwd_ref(*map(_t, (x, a_log, b, c, dt, dy)))
    xg, ag, bg, cg, dtg = (t.grad for t in leaves)
    for g, w in zip((xg, bg, cg, dtg, ag), want):
        assert torch.equal(g, w)
    with torch.no_grad():
        plain = ops.ssd_scan(*leaves)
    assert plain.grad_fn is None
    assert torch.equal(plain, ref.ssd_scan_ref(*map(_t, (x, a_log, b, c,
                                                          dt))))


def test_flash_attention_takes_a_gradient():
    """The refusal this test held is gone: with a gradient required,
    ``ops.flash_attention`` runs its autograd function (on CPU tensors
    the plain forward and backward, no launch), as ``ops.ssd_scan`` does;
    under ``no_grad`` it builds no graph."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 5, 8), generator=g, requires_grad=True)
    dout = torch.randn((1, 2, 5, 8), generator=g)
    before = kfa.flash_attention_bwd_cuda.launches
    o = ops.flash_attention(q, q, q)
    assert o.grad_fn is not None
    o.backward(dout)
    assert kfa.flash_attention_bwd_cuda.launches == before
    x = q.detach()
    po, lse = ref.attention_ref(x, x, x, return_lse=True)
    dq, dk, dv = ref.flash_attention_bwd_ref(x, x, x, po, lse, dout)
    assert torch.equal(q.grad, dq + dk + dv)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None


def test_bwd_plan_sizes():
    """The workspace at mamba2-130m's training step, and the register
    sub-chunk by head width."""
    p = kssd.bwd_plan(8, 1024, 24, 64, 128)
    assert (p.rows, p.sub, p.blocks) == (64, 8, 768)
    assert p.work_floats * 4 < 2 ** 30
    assert kssd.bwd_plan(1, 5, 2, 100, 40)[:3] == (128, 4, 4)
    with pytest.raises(ValueError, match="head width"):
        kssd.bwd_plan(1, 5, 2, 129, 40)
