"""The flash-attention gradient on the CPU: the port's plain backward
(``ref.flash_attention_bwd_ref``, what ``csrc/flash_attention_bwd.cu``
computes) and its plain log-sum-exp against ``jax.vjp`` of the
reference's custom VJP (``repro.models.flash_xla.flash_attention_xla``)
and against torch autograd of the plain forward; ``ops.flash_attention``
under autograd (on CPU tensors its backward is the plain version); the
blocked emulation of the kernel's tensor-core design
(``ref.flash_attention_bwd_blocked_ref``: its tiles and summation
order) against the reference and, with its bf16 rounding points,
against the float32 plain version at the card's tolerance; and the
gradient's launch plan.

Shapes: the reference's own (``tests/test_flash_xla.py``): causal MHA,
GQA with Sk = 2,500 and no mask, causal MQA.  Tolerances: float32
rtol = atol = 1e-4 (the same float32 function summed in other orders);
bf16 2e-2 (both round P and dS to bf16 at the same points, but a value
that lands next to a rounding boundary may round the other way on one
side, and each output is rounded to bf16: a few bf16 steps of the
gradients' magnitude).
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import flash_xla as jflash  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.attention import Attention  # noqa: E402
from repro_torch.models.flash_xla import flash_attention_xla  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

SHAPES = {  # B, H, Hkv, Sq, Sk, dh, causal
    "causal": (1, 4, 4, 256, 256, 32, True),
    "gqa_sk2500": (2, 4, 2, 128, 2500, 32, False),
    "mqa": (1, 8, 1, 512, 512, 64, True),
}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SMEM = 232_448


@functools.lru_cache(maxsize=None)
def _case(name, dtype):
    """Seeded numpy inputs (q, k, v, dout), rounded to ``dtype``, and the
    reference's (out, lse, dq, dk, dv) for them, as float32 numpy; one
    reference run per case."""
    B, H, Hkv, Sq, Sk, dh, causal = SHAPES[name]
    rng = np.random.default_rng(Sq + Sk + dh)
    mk = lambda *s, sc=0.5: (rng.standard_normal(s) * sc).astype(np.float32)
    jdt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(a, jdt) for a in (
        mk(B, H, Sq, dh), mk(B, Hkv, Sk, dh), mk(B, Hkv, Sk, dh)))
    dout = jnp.asarray(mk(B, H, Sq, dh, sc=1.0), jdt)
    out, vjp = jax.vjp(lambda *a: jflash.flash_attention_xla(*a, causal),
                       q, k, v)
    _, (_, _, _, _, lse) = jflash._fwd(q, k, v, causal, None)
    grads = vjp(dout)
    f32 = lambda a: np.array(jnp.asarray(a, jnp.float32))
    inputs = tuple(f32(a) for a in (q, k, v, dout))
    want = (f32(out), f32(lse).reshape(B, H, Sq)) + tuple(map(f32, grads))
    return inputs, want


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype, what):
    np.testing.assert_allclose(got.float().numpy(), want, err_msg=what,
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_backward_and_lse_match_the_reference_vjp(name, dtype):
    (q, k, v, dout), (out, lse, dq, dk, dv) = _case(name, dtype)
    causal = SHAPES[name][-1]
    q, k, v, dout = (_torch(a, dtype) for a in (q, k, v, dout))
    o, got_lse = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
    assert got_lse.dtype == torch.float32
    _close(o, out, dtype, "out")
    _close(got_lse, lse, "float32", "lse")
    grads = ref.flash_attention_bwd_ref(q, k, v, o, got_lse, dout,
                                        causal=causal)
    for g, w, what, t in zip(grads, (dq, dk, dv), ("dq", "dk", "dv"),
                             (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, dtype, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_backward_matches_autograd_of_the_plain_forward(name, dtype):
    """torch autograd through ``attention_ref`` (its softmax's own
    backward, no rounding of P or dS) at the same tolerances."""
    (q, k, v, dout), _ = _case(name, dtype)
    causal = SHAPES[name][-1]
    leaves = [_torch(a, dtype).requires_grad_() for a in (q, k, v)]
    dout = _torch(dout, dtype)
    o = ref.attention_ref(*leaves, causal=causal)
    o.backward(dout)
    with torch.no_grad():
        o, lse = ref.attention_ref(*leaves, causal=causal, return_lse=True)
        grads = ref.flash_attention_bwd_ref(*leaves, o, lse, dout,
                                            causal=causal)
    for g, t, what in zip(grads, leaves, ("dq", "dk", "dv")):
        _close(g, t.grad.float().numpy(), dtype, what)


def test_ops_flash_attention_gradient_is_the_plain_backward():
    """On CPU tensors the autograd function's forward is attention_ref
    with its lse and its backward flash_attention_bwd_ref, bitwise, with
    no kernel launch counted; the reference's name for it,
    ``models.flash_xla.flash_attention_xla``, is the same call; without a
    gradient there is no graph."""
    (q, k, v, dout), _ = _case("gqa_sk2500", "float32")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    dout = torch.from_numpy(dout)
    before = (kfa.flash_attention_cuda.launches,
              kfa.flash_attention_bwd_cuda.launches)
    o = ops.flash_attention(*leaves, causal=False)
    assert o.grad_fn is not None
    o.backward(dout)
    assert (kfa.flash_attention_cuda.launches,
            kfa.flash_attention_bwd_cuda.launches) == before
    plain = [torch.from_numpy(a) for a in (q, k, v)]
    po, lse = ref.attention_ref(*plain, causal=False, return_lse=True)
    assert torch.equal(o.detach(), po)
    want = ref.flash_attention_bwd_ref(*plain, po, lse, dout, causal=False)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    again = [t.detach().clone().requires_grad_() for t in leaves]
    flash_attention_xla(*again, False).backward(dout)
    for t, w in zip(again, want):
        assert torch.equal(t.grad, w)
    with torch.no_grad():
        assert ops.flash_attention(*leaves, causal=False).grad_fn is None


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_blocked_backward_matches_the_reference_vjp(name):
    """The tensor-core design's tiling and summation order (64-key dK/dV
    tiles walking the group's heads and 64-query tiles in order; 128-row
    dQ tiles walking key tiles in order) in float32 is the reference's
    gradient, at the float32 tolerance."""
    (q, k, v, dout), (_, lse, dq, dk, dv) = _case(name, "float32")
    causal = SHAPES[name][-1]
    q, k, v, dout = (_torch(a, "float32") for a in (q, k, v, dout))
    o, lse = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
    grads = ref.flash_attention_bwd_blocked_ref(q, k, v, o, lse, dout,
                                                causal=causal)
    for g, w, what in zip(grads, (dq, dk, dv), ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        _close(g, w, "float32", what)


WIDE = {  # B, H, Hkv, Sq, Sk, dh, causal: gemma-7b's head width, ragged
    "wide_gqa_causal": (1, 4, 2, 200, 200, 256, True),
    "wide_unequal": (1, 2, 1, 70, 130, 256, False),
}


@pytest.mark.parametrize("name", sorted(SHAPES) + sorted(WIDE))
def test_blocked_backward_with_bf16_rounding_is_within_the_card_tolerance(
        name):
    """On bf16 inputs the emulation rounds P and dS to bf16 where the
    kernel does; its gradient stays within the card's FLASH_BWD_TOL (1e-2
    of each output's largest magnitude) of the float32 plain version on
    the same values, and of the plain version with the same rounding."""
    B, H, Hkv, Sq, Sk, dh, causal = {**SHAPES, **WIDE}[name]
    rng = np.random.default_rng(Sq * Sk + dh)
    mk = lambda *s, sc=0.5: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).bfloat16()
    q, k, v = mk(B, H, Sq, dh), mk(B, Hkv, Sk, dh), mk(B, Hkv, Sk, dh)
    dout = mk(B, H, Sq, dh, sc=1.0)
    f32 = [t.float() for t in (q, k, v)]
    o, lse = ref.attention_ref(*f32, causal=causal, return_lse=True)
    exact = ref.flash_attention_bwd_ref(*f32, o, lse, dout.float(),
                                        causal=causal)
    got = ref.flash_attention_bwd_blocked_ref(q, k, v, o.bfloat16(), lse,
                                              dout, causal=causal)
    rounded = ref.flash_attention_bwd_ref(q, k, v, o.bfloat16(), lse, dout,
                                          causal=causal)
    for want in (exact, rounded):
        scale = max(float(w.float().abs().max()) for w in want)
        for g, w, what in zip(got, want, ("dq", "dk", "dv")):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            np.testing.assert_allclose(
                g.float().numpy(), w.float().numpy(), rtol=1e-2,
                atol=1e-2 * scale, err_msg=what)


def test_bwd_plan_sizes():
    """Every head width either design takes gets a plan within a block's
    shared memory: bf16 with dh % 16 == 0 on tensor cores (one block an
    SM at dh = 256: two stages of 64-row Q and dO tiles beside the
    resident K and V; three of 32-row K and V tiles beside 128 rows of Q
    and dO), float32 on CUDA cores; a zero stride (a broadcast TMA
    cannot step) or an unaligned input takes CUDA cores; what neither
    design takes is refused."""
    for dtype in (torch.float32, torch.bfloat16):
        for dh in range(4, kfa.MAX_DH + 1, 4):
            p = kfa.bwd_plan(dtype, dh, 1024, 1024,
                             strides=[dh * 8, dh, dh] * 5)
            tc = dtype == torch.bfloat16 and dh % 16 == 0
            assert p.design == ("tensor_core" if tc else "cuda_core"), dh
            for smem in (p.dkdv_smem_bytes, p.dq_smem_bytes):
                assert 0 < smem <= SMEM, (dh, p)
            if tc:
                dmp = kfa.padded_width(dh)
                assert dmp in (64, 128, 256) and dh <= dmp
                assert dmp == 64 or dmp // 2 < dh, (dh, dmp)
                assert (p.key_rows, p.query_tile, p.dq_rows, p.dkdv_stages,
                        p.dq_stages) == (64, 64, 128, 2, 3), (dh, p)
                assert p.dq_key_tile == (64 if dh <= 128 else 32), (dh, p)
    p = kfa.bwd_plan(torch.bfloat16, 256, 1024, 1024)
    assert p == kfa.BwdPlan("tensor_core", 64, 64, 128, 32, 2, 3, 206_912,
                            230_464, 2 * 1024)
    assert kfa.bwd_plan(torch.bfloat16, 64, 65, 65).workspace_rows == 256
    assert kfa.bwd_plan(torch.float32, 64, 65, 65).workspace_rows == 65
    assert kfa.bwd_plan(torch.bfloat16, 256, 8, 8, strides=[256, 256, 255],
                        ).design == "cuda_core"
    assert kfa.bwd_plan(torch.bfloat16, 64, 8, 8, strides=[512, 0, 64],
                        ).design == "cuda_core"
    assert kfa.bwd_plan(torch.bfloat16, 64, 8, 8,
                        aligned=False).design == "cuda_core"
    for dh in (0, 2, 130, 260):
        with pytest.raises(ValueError, match="head width"):
            kfa.bwd_plan(torch.bfloat16, dh, 8, 8)
    with pytest.raises(ValueError, match="too long"):
        kfa.bwd_plan(torch.bfloat16, 64, 8, 64 * 65536)
    with pytest.raises(ValueError, match="too long"):
        kfa.bwd_plan(torch.float32, 64, 8, 8 * 65536)


def test_gemma_training_inputs_take_the_tensor_core_backward():
    """gemma-7b at its published width (meta device, nothing allocated):
    q, k, v as the attention layer passes them (views of the
    projections), o as the forward allocates it and dout in the layout
    autograd hands back through the output's transpose and reshape take
    the tensor-core gradient."""
    cfg = get_config("gemma-7b")
    attn = Attention(cfg, device="meta")
    B, S, H, hd = 2, 1024, cfg.n_heads, cfg.hd
    x = torch.empty((B, S, cfg.d_model), dtype=cfg.cdtype, device="meta")
    q, k, v = ((x @ w).view(B, S, H, hd).transpose(1, 2)
               for w in (attn.wq, attn.wk, attn.wv))
    o = torch.empty_like(q)
    dout = torch.empty((B, S, H * hd), dtype=q.dtype,
                       device="meta").view(B, S, H, hd).transpose(1, 2)
    strides = [s for t in (q, k, v, o, dout) for s in t.stride()[:3]]
    assert kfa.bwd_plan(q.dtype, hd, S, S, strides=strides).design == \
        "tensor_core"
