"""The SSD scan's gradient on the CPU: the port's plain reverse recurrence
(``ref.ssd_scan_bwd_ref``, what the gradient kernel computes) against
``jax.vjp`` of the reference's sequential scan and against torch
autograd of the port's plain forward; the chunked decomposition of the
"tensor_core" design (``ref.ssd_scan_bwd_chunked_ref``) against both,
and with the design's bf16 rounding points against the float32 plain
version; ``ops.ssd_scan``'s autograd function, whose backward on CPU
tensors is that plain version; and ``bwd_plan``.

Tolerance: every input's gradient within rtol = atol = 1e-4 (float32
sums of the same terms in another order; the reference's own
chunked-vs-sequential tolerance is 2e-4); the bf16 rounding mode within
the card tests' bf16 tolerance (``_ssd_grads_close``) and within
chip_smoke.py's (dx, db, dc 1e-2 and ddt, da_log 1e-3 of each output's
largest magnitude).
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
from test_torch_cuda import _ssd_grads_close  # noqa: E402
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


@pytest.mark.parametrize("B,S,H,G,P,N,mamba,chunk", [
    (2, 70, 4, 1, 8, 16, False, 64),     # one group, S off any chunk
    (1, 45, 4, 2, 16, 8, False, 64),     # two groups
    (2, 33, 4, 2, 8, 8, True, 64),       # mamba2's decay rates (a to -16)
    (1, 33, 2, 2, 16, 40, False, 64),    # P = 16, N = 40
    (1, 130, 2, 1, 64, 128, True, 64),   # mamba2's head, three chunks
    (2, 70, 4, 2, 16, 16, True, 8),      # many short chunks
])
def test_chunked_gradient_matches_jax_vjp(B, S, H, G, P, N, mamba, chunk):
    """The tensor-core design's decomposition in float32 (chunk states,
    state passing both ways, per-chunk gradients, dcum's reverse running
    sum) is the gradient: jax.vjp of the reference's scan and the plain
    reverse recurrence."""
    x, a_log, b, c, dt, dy = _case(S + H + P, B, S, H, G, P, N, mamba)
    args = tuple(map(_t, (x, a_log, b, c, dt, dy)))
    got = ref.ssd_scan_bwd_chunked_ref(*args, chunk=chunk)
    want = _reference_vjp(x, a_log, b, c, dt, dy)
    plain = ref.ssd_scan_bwd_ref(*args)
    for name, g, w, p in zip(NAMES, got, want, plain):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("B,S,H,G,P,N,mamba", [
    (2, 77, 4, 2, 32, 16, False),        # odd S, two groups
    (2, 300, 4, 1, 64, 128, True),       # mamba2's head and rates
    (1, 1024, 4, 1, 64, 128, False),     # a training row, 16 chunks
    (1, 256, 24, 1, 64, 128, True),      # db, dc summed over 24 heads
])
def test_chunked_gradient_bf16_rounding_meets_the_card_tolerance(
        B, S, H, G, P, N, mamba):
    """bf16 inputs, rounded where the kernel rounds (w x and exp(cum) dy
    and the states h0, G as bf16 hi + lo pairs, M1 and M2 once): within
    the card tests' bf16 tolerance of the float32 plain version, and
    within chip_smoke.py's relative one."""
    x, a_log, b, c, dt, dy = _case(S + P, B, S, H, G, P, N, mamba)
    bf = lambda a: _t(a).bfloat16()
    args = (bf(x), _t(a_log), bf(b), bf(c), _t(dt), bf(dy))
    got = ref.ssd_scan_bwd_chunked_ref(*args, bf16_operands=True)
    want = ref.ssd_scan_bwd_ref(*args)
    _ssd_grads_close(got, want)
    for name, g, w in zip(NAMES, got, want):
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        tol = 1e-2 if name in ("dx", "db", "dc") else 1e-3
        assert torch.allclose(g, w, rtol=tol, atol=tol * scale), name


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
    """The design and workspace by dtype, widths and alignment: bf16 at
    mamba2-130m's training step takes the chunked "tensor_core" design
    (a block per (batch, head, chunk)); float32, bf16 off its widths and
    misaligned strides the "cuda_core" one; P past 128 raises."""
    p = kssd.bwd_plan(torch.bfloat16, 8, 1024, 24, 64, 128,
                      strides=[1572864, 1536, 64, 1] * 2 + [2304, 256, 128, 1]
                      * 2)
    assert (p.design, p.blocks) == ("tensor_core", 3072)
    assert 2 ** 28 < p.work_floats * 4 < 2 ** 29     # ~403 MB
    assert p.smem_bytes <= kssd.SMEM_LIMIT // 2     # two blocks an SM
    cc = kssd.bwd_plan(torch.float32, 8, 1024, 24, 64, 128)
    assert (cc.design, cc.blocks) == ("cuda_core", 768)
    assert cc.work_floats * 4 < 2 ** 30
    for P, N, kw in ((100, 64, {}), (64, 40, {}), (80, 128, {}),
                     (64, 128, {"aligned": False}),
                     (64, 128, {"strides": [64, 64, 64, 2]}),
                     (64, 128, {"strides": [68, 68, 68, 1]})):
        assert kssd.bwd_plan(torch.bfloat16, 1, 5, 2, P, N,
                             **kw).design == "cuda_core", (P, N, kw)
    assert kssd.bwd_plan(torch.bfloat16, 1, 5, 2, 100, 40).blocks == 4
    with pytest.raises(ValueError, match="head width"):
        kssd.bwd_plan(torch.bfloat16, 1, 5, 2, 129, 40)
