"""The port's model zoo (dense attention family) against the JAX reference.

The same numpy inputs, made from a seed, go through ``repro.models`` /
``repro.kernels`` and their counterparts in ``repro_torch`` on the CPU,
where the port's attention runs the flash kernel's plain version
(``kernels/ref.attention_ref``).  Weights carry across through
``convert.model_params_from_arrays``.  Tolerances:
  * layers: rtol = atol = 1e-5 (float32; the two frameworks round
    transcendental functions and sums in their own order);
  * attention: rtol = atol = 2e-5 against the reference's plain version
    and against its Pallas kernel in interpret mode, as the reference's
    own kernel test (``tests/test_kernels.py``); bf16 at 0.05;
  * forward logits of the reduced configs (float32, 2 layers): rtol =
    atol = 1e-4 (two layers of float32 products).  ``embed_texts`` is
    held against the reference in ``test_torch_retrieval.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import forward, init_params, layers  # noqa: E402
from repro_torch.models.attention import sdpa  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
DENSE_ARCHS = ["gemma-7b", "codeqwen1.5-7b", "phi3-mini-3.8b",
               "mistral-nemo-12b"]
# GeGLU, tied head, softcap; SwiGLU, GQA, untied head, theta 1e6; MoE
# with GQA and a tied head; MLA with a dense block, then MoE with shared
# experts, untied head
FORWARD_ARCHS = ["gemma-7b", "mistral-nemo-12b", "granite-moe-1b-a400m",
                 "deepseek-v2-lite-16b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"]


def _np(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    x, scale = _np(0, 3, 7, 96), _np(1, 96) + 1.0
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = layers.rmsnorm(_t(scale), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_matches_reference(theta):
    x = _np(2, 2, 3, 100, 48)
    pos = np.arange(100)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_gated_mlp_matches_reference(act):
    d, f = 96, 256
    x = _np(3, 4, 9, d)
    w = {"w_gate": _np(4, d, f, scale=d ** -0.5),
         "w_up": _np(5, d, f, scale=d ** -0.5),
         "w_down": _np(6, f, d, scale=f ** -0.5)}
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                       jnp.asarray(x), act)
    m = layers.MLP(d, f, act, torch.float32)
    for k, v in w.items():
        getattr(m, k).copy_(_t(v))
    np.testing.assert_allclose(m(_t(x)).numpy(), np.asarray(want),
                               **LAYER_TOL)


# ---------------------------------------------------------------------------
# attention: the plain version against the reference's plain version and
# its Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,S,dh", [
    (1, 2, 2, 128, 64),     # MHA, one aligned tile
    (2, 4, 2, 100, 48),     # GQA group 2, unaligned, the reduced width
    (1, 4, 1, 100, 256),    # MQA at gemma-7b's head width
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_reference_and_pallas(B, H, Hkv, S, dh, causal):
    q = _np(10 + dh, B, H, S, dh, scale=0.5)
    k = _np(20 + dh, B, Hkv, S, dh, scale=0.5)
    v = _np(30 + dh, B, Hkv, S, dh, scale=0.5)
    got = sdpa(_t(q), _t(k), _t(v), causal=causal).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    plain = jref.attention_ref(jq, jk, jv, causal=causal)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got, np.asarray(plain), **ATTN_TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **ATTN_TOL)


def test_attention_non_causal_unequal_lengths():
    q = _np(40, 1, 4, 64, 64, scale=0.5)
    k, v = _np(41, 1, 2, 100, 64, scale=0.5), _np(42, 1, 2, 100, 64)
    got = sdpa(_t(q), _t(k), _t(v), causal=False).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(
        got, np.asarray(jops.flash_attention(jq, jk, jv, causal=False)),
        **ATTN_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.attention_ref(jq, jk, jv, causal=False)),
        **ATTN_TOL)


def test_attention_bf16():
    q, k, v = (_np(50 + i, 1, 2, 128, 64, scale=0.5) for i in range(3))
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = jref.attention_ref(jb(q), jb(k), jb(v), causal=True)
    tb = lambda a: _t(a).to(torch.bfloat16)
    got = sdpa(tb(q), tb(k), tb(v), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)


def test_causal_attention_with_unequal_lengths_is_refused():
    """The TPU kernel aligns the causal mask top-left, the reference's
    plain version bottom-right: they differ unless Sq == Sk, so neither
    is picked."""
    q, k = torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 6, 16)
    before = kfa.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="Sq == Sk"):
        kfa.flash_attention_cuda(q, k, k, causal=True)
    assert kfa.flash_attention_cuda.launches == before
    out = kfa.flash_attention_cuda(q, k, k, causal=False)
    np.testing.assert_array_equal(
        out.numpy(), ref.attention_ref(q, k, k, causal=False).numpy())


# ---------------------------------------------------------------------------
# whole model: forward logits and the retrieval embedding
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_models():
    """{arch: (cfg, reference params, port model)} at the reduced width."""
    out = {}
    for i, arch in enumerate(FORWARD_ARCHS):
        jcfg = jget_config(arch, reduced=True)
        jp = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(i),
                                                     jcfg)
        cfg = get_config(arch, reduced=True)
        out[arch] = (jcfg, jp, convert.model_params_from_arrays(
            _tree_np(jp), cfg, device="cpu"))
    return out


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_logits_match_reference(reduced_models, arch):
    """The logits and the MoE balance loss summed over the blocks (0 for
    the dense family), as the reference's ``forward`` returns them."""
    jcfg, jp, model = reduced_models[arch]
    tokens = _tokens(7, 2, 24, jcfg.vocab)
    want, want_aux = jforward(jp, jcfg, jnp.asarray(tokens), remat=False)
    got, aux = forward(model, _t(tokens).long())
    assert got.shape == (2, 24, jcfg.vocab_padded)
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MODEL_TOL)
    assert (float(aux) > 0) == (arch in MOE_ARCHS)


def test_gemma_forward_through_the_pallas_kernel(reduced_models):
    """The reference's kernel path (forward(use_kernel=True), its Pallas
    kernel in interpret mode) is the function the port computes."""
    jcfg, jp, model = reduced_models["gemma-7b"]
    tokens = _tokens(8, 2, 100, jcfg.vocab)
    want, _ = jforward(jp, jcfg, jnp.asarray(tokens), use_kernel=True,
                       remat=False)
    got, _ = forward(model, _t(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_gemma_7b_config_is_the_published_width():
    cfg = get_config("gemma-7b")
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab, cfg.act) == (3072, 28, 16, 16, 256, 24576,
                                              256000, "gelu")
    assert cfg.pdtype == cfg.cdtype == torch.bfloat16
    assert cfg == get_config("gemma_7b")
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-5")
    for arch in DENSE_ARCHS:
        for reduced in (False, True):
            mine = get_config(arch, reduced=reduced)
            theirs = jget_config(arch, reduced=reduced)
            assert mine.name == theirs.name and mine.hd == theirs.hd
            assert mine.n_layers == theirs.n_layers
            assert mine.vocab_padded == theirs.vocab_padded


NEW_ARCHS = {"recurrentgemma-2b": 2_894_481_920,
             "whisper-medium": 959_571_968, "pixtral-12b": 12_247_782_400}


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS + ["mamba2-130m"]
                         + list(NEW_ARCHS))
def test_count_params_equals_the_reference(arch):
    """``count_params`` (the port's modules on the meta device: nothing
    allocated) is the reference's count (``jax.eval_shape`` of its
    ``init_params``), published and reduced; gemma-7b's is 8.54 B."""
    from repro.models import count_params as jcount_params
    from repro_torch.models import count_params
    for reduced in (False, True):
        assert count_params(get_config(arch, reduced=reduced)) == \
            jcount_params(jget_config(arch, reduced=reduced))
    if arch == "gemma-7b":
        assert count_params(get_config(arch)) == 8_537_680_896
    if arch in NEW_ARCHS:
        assert count_params(get_config(arch)) == NEW_ARCHS[arch]


@pytest.mark.parametrize("arch", list(NEW_ARCHS))
def test_new_family_archs_load_at_their_published_width(arch):
    """The archs the registry once refused load: the reference's ids and
    underscore forms, the published and reduced configs its own, and a
    model of the published config builds on the meta device with the
    reference's leaf paths (an RG-LRU's ``lam`` float32 in the bf16
    model)."""
    from repro.models import count_params as jcount_params
    from repro_torch.models import Transformer, param_tree
    cfg = get_config(arch)
    assert cfg == get_config(arch.replace("-", "_"))
    theirs = jget_config(arch)
    assert (cfg.name, cfg.n_layers, cfg.d_model, cfg.hd, cfg.vocab_padded,
            cfg.encoder_layers, cfg.frontend_tokens) == (
        theirs.name, theirs.n_layers, theirs.d_model, theirs.hd,
        theirs.vocab_padded, theirs.encoder_layers, theirs.frontend_tokens)
    assert cfg.pdtype == cfg.cdtype == torch.bfloat16
    model = Transformer(cfg, device="meta")
    want = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0),
                                               theirs))
    got = param_tree(model)
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    wflat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert sorted(map(str, flat)) == sorted(map(str, wflat))
    for path, t in flat.items():
        assert tuple(t.shape) == wflat[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == \
            str(wflat[path].dtype), path
    assert sum(t.numel() for t in flat.values()) == jcount_params(theirs)


def test_init_params_draws_the_reference_distributions():
    cfg = get_config("gemma-7b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    model = init_params(cfg, generator=gen, device="cpu")
    assert abs(float(model.embed_table.std()) - 0.02) < 0.002
    blk = model.segments[0][0]
    for w, fan_in in ((blk.attn.wq, cfg.d_model), (blk.attn.wo,
                      cfg.n_heads * cfg.hd), (blk.mlp.w_down, cfg.d_ff)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1
    assert torch.all(blk.norm_mix.scale == 1)
    again = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert torch.equal(again.segments[0][1].mlp.w_up,
                       model.segments[0][1].mlp.w_up)
