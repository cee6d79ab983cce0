"""The port's encoder, cross-attention and modality stubs against the JAX
reference: reduced whisper-medium (an encoder of 2 non-causal blocks
over 30 stub frames, 2 decoder blocks with cross-attention) and reduced
pixtral-12b (16 stub patch rows prepended to the text).

The same numpy inputs, made from a seed, go through ``repro.models``
and ``repro_torch.models`` on the CPU, where the port's attention runs
the flash kernel's plain version and its gradient's; weights carry
across through ``convert.model_params_from_arrays``.  Tolerance: rtol =
atol = 1e-4 in float32 (the model tolerance of ``test_torch_models.py``)
for the encoder's output, the cross-attention, the cross cache, the
logits, the loss and every gradient leaf.  Prefill and decode through
the cross cache are in ``test_torch_decode.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import (encode, forward, hidden_states,  # noqa: E402
                                init_cache, loss_fn, value_and_grad)
from repro_torch.models import transformer as tf  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["whisper-medium", "pixtral-12b"]
B, S = 2, 12


def _np(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **MODEL_TOL,
                               err_msg=what)


@pytest.fixture(scope="module")
def models():
    """{arch: (reference config, reference params, port model, tokens,
    the stub inputs as numpy)}."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jget_config(arch, reduced=True)
        jp = jax.jit(jinit_params, static_argnums=1)(
            jax.random.PRNGKey(30 + i), jcfg)
        model = convert.model_params_from_arrays(
            jax.tree.map(np.asarray, jp), get_config(arch, reduced=True),
            device="cpu")
        tokens = np.random.default_rng(40 + i).integers(
            0, jcfg.vocab, (B, S + 1)).astype(np.int32)
        stubs = ({"enc_frames": _np(50, B, jcfg.encoder_frames, jcfg.d_model)}
                 if jcfg.encoder_layers else
                 {"frontend_emb": _np(51, B, jcfg.frontend_tokens,
                                      jcfg.d_model)})
        out[arch] = (jcfg, jp, model, tokens, stubs)
    return out


def _j(stubs):
    return {k: jnp.asarray(a) for k, a in stubs.items()}


def _t(stubs):
    return {k: torch.from_numpy(a) for k, a in stubs.items()}


def test_encode_matches_reference(models):
    """The encoder's output: 2 non-causal ATTN blocks with RoPE over 30
    frames, then its norm."""
    jcfg, jp, model, _, stubs = models["whisper-medium"]
    frames = stubs["enc_frames"]
    want = jtf.encode(jp, jcfg, jnp.asarray(frames))
    got = encode(model, torch.from_numpy(frames)).detach()
    assert got.shape == (B, jcfg.encoder_frames, jcfg.d_model)
    _close(got.numpy(), want, "encode")


def test_cross_attention_matches_reference(models):
    """Queries from x, K/V from the encoder's output, and at decode from
    the cache's xk/xv (the reference's ``enc_out="cached"``): both the
    reference's, whatever the query rows."""
    jcfg, jp, model, _, _ = models["whisper-medium"]
    jblock = jax.tree.map(lambda a: a[1], jp["segments"][0]["b0"])
    block = model.segments[0][1]
    enc = _np(52, B, jcfg.encoder_frames, jcfg.d_model)
    for rows in (1, 7):
        x = _np(53 + rows, B, rows, jcfg.d_model)
        want, _ = jtf._cross_attention(jblock["cross"], jcfg, jnp.asarray(x),
                                       jnp.asarray(enc), None)
        got = tf._cross_attention(block.cross, model.cfg, torch.from_numpy(x),
                                  torch.from_numpy(enc), None)
        _close(got.numpy(), want, f"{rows} rows from enc_out")
        Hkv, hd = jcfg.n_kv_heads, jcfg.hd
        cache = {k: (torch.from_numpy(enc) @ w).view(B, -1, Hkv, hd)
                 .transpose(1, 2) for k, w in (("xk", block.cross.wk),
                                               ("xv", block.cross.wv))}
        got = tf._cross_attention(block.cross, model.cfg, torch.from_numpy(x),
                                  None, cache)
        want, _ = jtf._cross_attention(
            jblock["cross"], jcfg, jnp.asarray(x), "cached",
            {k: jnp.asarray(t.numpy()) for k, t in cache.items()})
        _close(got.numpy(), want, f"{rows} rows from the cache")


def test_fill_cross_cache_matches_reference(models):
    """Every decoder block's xk/xv of the encoder's output, written in
    place, equal to the reference's ``_fill_cross_cache``; the K/V of
    the self-attention stay zero."""
    jcfg, jp, model, _, _ = models["whisper-medium"]
    enc = _np(60, B, jcfg.encoder_frames, jcfg.d_model)
    want = jtf._fill_cross_cache(jp, jcfg, jtf.init_cache(jcfg, B, 16),
                                 jnp.asarray(enc))
    cache = init_cache(model.cfg, B, 16, device="cpu")
    tf._fill_cross_cache(model, cache, torch.from_numpy(enc))
    got = convert.cache_arrays(cache)
    for key in ("xk", "xv", "k", "v"):
        _close(got[0]["b0"][key], want[0]["b0"][key], key)
    assert not got[0]["b0"]["k"].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    """The logits of the token rows (pixtral's patch rows dropped before
    the head) and the balance loss (0)."""
    jcfg, jp, model, tokens, stubs = models[arch]
    want, want_aux = jtf.forward(jp, jcfg, jnp.asarray(tokens), **_j(stubs))
    got, aux = forward(model, torch.from_numpy(tokens).long(), **_t(stubs))
    assert got.shape == (B, S + 1, jcfg.vocab_padded)
    _close(got.numpy(), want, "logits")
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(models, arch):
    """``value_and_grad`` against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` with the same stub inputs: the loss and every
    leaf of the gradient tree (whisper's encoder, through the
    cross-attention of every decoder block, included)."""
    jcfg, jp, model, tokens, stubs = models[arch]
    toks, labels = tokens[:, :-1], tokens[:, 1:]
    jl, jg = jax.value_and_grad(lambda p: jloss_fn(
        p, jcfg, jnp.asarray(toks), jnp.asarray(labels), **_j(stubs)))(jp)
    loss, grads = value_and_grad(model, torch.from_numpy(toks).long(),
                                 torch.from_numpy(labels).long(),
                                 **_t(stubs))
    _close(float(loss), float(jl), "loss")
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), grads))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    assert sorted(map(str, dict(got))) == sorted(map(str, want))
    if arch == "whisper-medium":
        assert any("encoder" in str(p) for p, _ in got)
    for path, g in got:
        _close(g, want[path], jax.tree_util.keystr(path))


def test_encoder_decoder_needs_its_frames(models):
    """Without ``enc_frames`` an encoder-decoder raises a ``ValueError``
    naming them (the reference dies on ``None.astype``): in ``forward``,
    ``loss_fn`` and the training CLI, which trains on tokens alone."""
    _, _, model, tokens, _ = models["whisper-medium"]
    t = torch.from_numpy(tokens).long()
    with pytest.raises(ValueError, match="enc_frames"):
        forward(model, t)
    with pytest.raises(ValueError, match="enc_frames"):
        loss_fn(model, t, t)
    with pytest.raises(ValueError, match="enc_frames"):
        train.main(["--device", "cpu", "--arch", "whisper-medium",
                    "--reduced", "--steps", "2", "--batch", "1", "--seq",
                    "8"])


def test_patch_rows_take_cache_positions(models):
    """pixtral's patch rows run through the blocks at positions 0 .. P-1
    (``hidden_states`` keeps them), so a prompt of S tokens fills P + S
    cache positions; its forward without patches is the text model's."""
    jcfg, jp, model, tokens, stubs = models["pixtral-12b"]
    t = torch.from_numpy(tokens).long()
    P = jcfg.frontend_tokens
    h = hidden_states(model, t, **_t(stubs))
    assert h.shape == (B, P + S + 1, jcfg.d_model)
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(tokens))
    _close(forward(model, t)[0].numpy(), want, "no patches")
