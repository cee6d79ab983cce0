"""The port's multi-head latent attention (MLA) and its flash kernels with
v narrower than q and k, against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through
``repro.models.attention`` (``mla_attention``, ``_mla_absorbed_decode``)
and ``repro.models.flash_xla.flash_attention_xla`` (with ``jax.vjp``)
and their counterparts in ``repro_torch``, at the reduced
deepseek-v2-lite-16b width (4 heads, kv_lora 64, q/k 32 + 16, v 32),
with the reference's ``init_mla`` weights carried across.  On the CPU
the port's flash wrappers run their plain versions; on the card they
zero-pad v (and, in the gradient, o and dout) to q's width, whose
premise -- the padded columns change nothing -- is held here on the
plain versions.  Tolerances: float32 rtol = atol = 2e-5 for attention
(the reference's kernel tolerance) and 1e-4 for a block and every
gradient (the model tolerance); bf16 0.05.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.flash_xla import flash_attention_xla  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.05, atol=0.05)
ARCH = "deepseek-v2-lite-16b"
B, SMAX = 2, 20


def _np(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mla(dtype="float32", seed=0):
    """(reference config, its init_mla params, port config, port MLA)."""
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True),
                               param_dtype=dtype, compute_dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              param_dtype=dtype, compute_dtype=dtype)
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg)
    m = attn.MLA(cfg, device="cpu")
    with torch.no_grad():
        for name, t in m.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name], np.float32)))
    return jcfg, jp, cfg, m


def _both(a, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(jdt))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def _latent_cache(cfg, seed, rows, dtype):
    """A latent cache of B x SMAX whose first ``rows`` positions hold
    values (an earlier prompt's) and the rest zeros, in both packages."""
    m = cfg.mla
    ckv = np.zeros((B, SMAX, m.kv_lora), np.float32)
    kpe = np.zeros((B, SMAX, m.rope_dim), np.float32)
    ckv[:, :rows] = _np(seed, B, rows, m.kv_lora, scale=0.5)
    kpe[:, :rows] = _np(seed + 1, B, rows, m.rope_dim, scale=0.5)
    (tc, jc), (tk, jk) = _both(ckv, dtype), _both(kpe, dtype)
    return {"ckv": tc, "kpe": tk}, {"ckv": jc, "kpe": jk}


def test_mla_attention_matches_reference_without_a_cache():
    """The full sequence: the flash path (v 32 wide against q/k 48) on
    the port, the reference's exact einsum path."""
    jcfg, jp, cfg, m = _mla()
    x = _np(1, B, 24, cfg.d_model)
    want, _ = jattn.mla_attention(jp, jcfg, jnp.asarray(x))
    got = attn.mla_attention(m, cfg, torch.from_numpy(x))
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("pos0", [0, 9, "tensor"])
def test_mla_prompt_through_the_cache_matches_reference(pos0):
    """A prompt of 6 tokens written into the latent cache at pos0: at 0
    it attends to its own rows (the flash path), past 0 (an int or a 0-d
    tensor) to the cache's rows through the offset paths; the output and
    every cache row against the reference's."""
    jcfg, jp, cfg, m = _mla()
    at = 9 if pos0 == "tensor" else pos0
    cache, jcache = _latent_cache(cfg, 2, at, "float32")
    x = _np(3, B, 6, cfg.d_model)
    want, jnew = jattn.mla_attention(jp, jcfg, jnp.asarray(x), pos0=at,
                                     cache=jcache)
    got = attn.mla_attention(
        m, cfg, torch.from_numpy(x), cache=cache,
        pos0=torch.tensor(at) if pos0 == "tensor" else at)
    _close(got, want, MODEL_TOL)
    for key in ("ckv", "kpe"):
        _close(cache[key], jnew[key], MODEL_TOL, key)


@pytest.mark.parametrize("tensor_pos", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(dtype, tensor_pos):
    """One token at position 11 after 11 cached rows: the absorbed decode
    in the latent space (scores over the cache summed in float32, the
    new token an explicit term, rows >= pos masked) against the
    reference's, as the layer's output and alone; the new latent row
    written at pos and nowhere else."""
    tol = MODEL_TOL if dtype == "float32" else BF16_TOL
    jcfg, jp, cfg, m = _mla(dtype)
    pos = 11
    cache, jcache = _latent_cache(cfg, 4, pos, dtype)
    before = {k: t.clone() for k, t in cache.items()}
    x, jx = _both(_np(5, B, 1, cfg.d_model), dtype)
    want, delta = jattn.mla_attention(jp, jcfg, jx, pos0=pos, cache=jcache)
    got = attn.mla_attention(m, cfg, x, cache=cache,
                             pos0=torch.tensor(pos) if tensor_pos else pos)
    assert got.dtype == x.dtype
    _close(got, want, tol)
    for key in ("ckv", "kpe"):
        _close(cache[key][:, pos:pos + 1], delta[f"{key}@delta"], tol, key)
        rest = torch.ones(SMAX, dtype=torch.bool)
        rest[pos] = False
        assert torch.equal(cache[key][:, rest], before[key][:, rest])
    # the decode alone, on the same q and new latent row
    H, nope = cfg.n_heads, cfg.mla.nope_dim
    qd = nope + cfg.mla.rope_dim
    q = _np(6, B, H, 1, qd, scale=0.5)
    new = (_np(7, B, 1, cfg.mla.kv_lora, scale=0.5),
           _np(8, B, 1, cfg.mla.rope_dim, scale=0.5))
    (tq, jq), (tc, jc), (tk, jk) = (_both(a, dtype) for a in (q, *new))
    want = jattn._mla_absorbed_decode(jp, jcfg, jq[..., :nope],
                                      jq[..., nope:], jcache["ckv"],
                                      jcache["kpe"], jc, jk, pos)
    got = attn._mla_absorbed_decode(m, cfg, tq[..., :nope], tq[..., nope:],
                                    before["ckv"], before["kpe"], tc, tk,
                                    pos)
    _close(got, want, tol)


# ---------------------------------------------------------------------------
# the flash wrappers with v narrower than q and k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Bn,H,Hkv,S,dh,dv,causal", [
    (1, 4, 4, 40, 48, 32, True),      # the reduced MLA block's widths
    (2, 4, 2, 33, 64, 16, False),     # GQA, not causal
    (1, 2, 1, 70, 192, 128, True),    # deepseek-v2-lite's q/k and v
])
def test_flash_with_narrow_v_matches_flash_attention_xla(Bn, H, Hkv, S, dh,
                                                         dv, causal):
    """``ops.flash_attention`` (its plain versions on the CPU) against the
    reference's custom VJP: the output and, through autograd (the
    gradient wrapper), dq, dk and dv against ``jax.vjp``."""
    q = _np(10 + dh, Bn, H, S, dh, scale=0.5)
    k = _np(20 + dh, Bn, Hkv, S, dh, scale=0.5)
    v = _np(30 + dh, Bn, Hkv, S, dv)
    do = _np(40 + dh, Bn, H, S, dv)
    want, vjp = jax.vjp(lambda a, b, c: flash_attention_xla(a, b, c, causal),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (Bn, H, S, dv)
    _close(got, want, ATTN_TOL)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert g.shape == w.shape
        _close(g, w, MODEL_TOL, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_padded_v_changes_nothing_on_the_plain_versions(dtype):
    """What the card's wrappers do, on the plain versions: v, o and dout
    zero-padded from dv to dh give O's first dv columns and zeros past
    them, the same lse, and the same dq, dk and dv (its first dv
    columns): the padded columns add exact zeros to every sum."""
    dh, dv = 64, 40
    q, k = (torch.from_numpy(_np(50 + i, 1, 4, 30, dh, scale=0.5)).to(dtype)
            for i in range(2))
    v = torch.from_numpy(_np(52, 1, 4, 30, dv)).to(dtype)
    do = torch.from_numpy(_np(53, 1, 4, 30, dv)).to(dtype)
    o, lse = ref.attention_ref(q, k, v, return_lse=True)
    wide = lambda t: torch.nn.functional.pad(t, (0, dh - dv))  # noqa: E731
    ow, lsew = ref.attention_ref(q, k, wide(v), return_lse=True)
    assert torch.equal(ow[..., dv:], torch.zeros_like(ow[..., dv:]))
    np.testing.assert_allclose(ow[..., :dv].float(), o.float(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(lsew, lse, rtol=1e-6, atol=1e-6)
    narrow = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    padded = ref.flash_attention_bwd_ref(q, k, wide(v), wide(o), lse,
                                         wide(do))
    for name, n, p in zip(("dq", "dk", "dv"), narrow, padded):
        np.testing.assert_allclose(p[..., :n.shape[-1]].float(), n.float(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert torch.equal(padded[2][..., dv:], torch.zeros_like(
        padded[2][..., dv:]))


def test_flash_plans_take_deepseeks_head_width():
    """q/k 192 (nope 128 + rope 64) in bf16: the forward's tensor-core
    design (the 256-wide instantiation, 32-key tiles), and the
    gradient's, padded to 256 columns, within a block's shared memory:
    dK/dV 206,912 and dQ 230,464 bytes of the 232,448."""
    p = kfa.plan(torch.bfloat16, 192, 2048)
    assert (p.design, p.key_tile) == ("tensor_core", 32)
    b = kfa.bwd_plan(torch.bfloat16, 192, 2048, 2048)
    assert b.design == "tensor_core" and kfa.padded_width(192) == 256
    assert (b.dkdv_smem_bytes, b.dq_smem_bytes) == (206_912, 230_464)
    assert max(b.dkdv_smem_bytes, b.dq_smem_bytes) <= kfa.SMEM_LIMIT
    with pytest.raises(ValueError, match="dv <= dh"):
        kfa.flash_attention_cuda(torch.zeros(1, 2, 4, 32),
                                 torch.zeros(1, 2, 4, 32),
                                 torch.zeros(1, 2, 4, 48))
