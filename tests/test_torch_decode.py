"""The port's decode and cache path against the JAX reference.

The same numpy inputs, made from a seed, go through ``repro.models``
(``init_cache``, ``prefill``, ``decode_step``; jitted, on the CPU) and
their counterparts in ``repro_torch.models`` on the CPU, where a prompt
at position 0 runs the flash kernel's plain version.  Weights carry
across through ``convert.model_params_from_arrays`` and caches through
``convert.cache_from_arrays`` / ``cache_arrays``.  The inputs are the
reference's own ``test_prefill_then_decode_matches_forward``
(``tests/test_arch_smoke.py``): B = 2, a prompt of 31 tokens, Smax = 36,
then four decode steps; recurrentgemma's prompt is 70 tokens, past its
window of 64, and pixtral's 16 patch rows come before its prompt (the
stub embeddings, and whisper's encoder frames, drawn from a seed).  Tolerances:
  * the port against the reference, float32: rtol = atol = 1e-4 (the
    model tolerance of ``test_torch_models.py``): the prefill's last
    logits, every cache leaf after the prefill and after each step, each
    step's logits;
  * decode against the port's own full-sequence forward: rtol = atol =
    2e-3, the reference's own decode tolerance;
  * the score paths against the reference's: 2e-5 in float32 (its kernel
    tolerance, ``tests/test_kernels.py``), 0.05 in bf16.
"""
import dataclasses
import enum

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                prefill)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import config as pconfig  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
            torch.bfloat16: dict(rtol=0.05, atol=0.05)}
# GeGLU, tied head, softcap; SwiGLU, GQA, untied head; the SSM family;
# MoE with GQA; MLA's latent cache with a dense block and then MoE; the
# RG-LRU with sliding-window attention; the encoder-decoder's cross
# cache; patch rows before the prompt
ARCHS = ["gemma-7b", "mistral-nemo-12b", "mamba2-130m",
         "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
         "recurrentgemma-2b", "whisper-medium", "pixtral-12b"]
B, STEPS = 2, 4
# arch -> (prompt tokens, Smax); the rest (31, 36)
PROMPTS = {"recurrentgemma-2b": (70, 76), "pixtral-12b": (31, 52)}


def _prompt(arch):
    return PROMPTS.get(arch, (31, 36))


def _stubs(jcfg, seed):
    """The stub frontends' inputs as numpy: {"frontend_emb": (B, P, d)}
    for a VLM, {"enc_frames": (B, F, d)} for an encoder-decoder."""
    out = {}
    if jcfg.frontend_tokens:
        out["frontend_emb"] = _np(seed, B, jcfg.frontend_tokens,
                                  jcfg.d_model)
    if jcfg.encoder_layers:
        out["enc_frames"] = _np(seed + 1, B, jcfg.encoder_frames,
                                jcfg.d_model)
    return out


def _torch_stubs(stubs):
    return {k: torch.from_numpy(a) for k, a in stubs.items()}


def _np(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _same_tree(got, want, tol, what):
    """Every leaf of two cache trees (lists of {"b<j>": {leaf}})."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for name in g:
            assert sorted(g[name]) == sorted(w[name])
            for key in g[name]:
                _close(g[name][key], w[name][key], tol,
                       f"{what}: segment {i} {name}/{key}")


@pytest.fixture(scope="module")
def runs():
    """{arch: (port model, tokens, the stub inputs, the reference's
    prefill logits and cache, its step logits and caches, its jitted
    decode step)}.  Token t of a decode step sits at position P + t, P
    the patch rows."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jget_config(arch, reduced=True)
        prompt, smax = _prompt(arch)
        jp = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(i),
                                                     jcfg)
        model = convert.model_params_from_arrays(
            jax.tree.map(np.asarray, jp), get_config(arch, reduced=True),
            device="cpu")
        tokens = np.random.default_rng(10 + i).integers(
            0, jcfg.vocab, (B, prompt + STEPS)).astype(np.int32)
        stubs = _stubs(jcfg, 20 + i)
        jprefill = jax.jit(lambda p, t, c, kw, cfg=jcfg: jtf.prefill(
            p, cfg, t, c, **kw))
        jdecode = jax.jit(lambda p, t, c, pos, cfg=jcfg: jtf.decode_step(
            p, cfg, t, c, pos))
        last, cache = jprefill(jp, jnp.asarray(tokens[:, :prompt]),
                               jtf.init_cache(jcfg, B, smax),
                               {k: jnp.asarray(a) for k, a in stubs.items()})
        ref = {"prefill": (np.asarray(last), jax.tree.map(np.asarray,
                                                          cache))}
        steps = []
        for t in range(STEPS):
            pos = prompt + t
            logits, cache = jdecode(jp, jnp.asarray(tokens[:, pos:pos + 1]),
                                    cache, jnp.int32(_at(jcfg, pos)))
            steps.append((np.asarray(logits), jax.tree.map(np.asarray,
                                                           cache)))
        ref["steps"] = steps
        out[arch] = (model, tokens, stubs, ref,
                     lambda c, t, pos, jp=jp, f=jdecode: f(
                         jp, jnp.asarray(t), c, jnp.int32(pos)))
    return out


def _at(cfg, t):
    """The position of token t: after the patch rows, where there are."""
    return cfg.frontend_tokens + t


def _port_prefill(model, tokens, stubs):
    prompt, smax = _prompt(model.cfg.name.removesuffix("-reduced"))
    cache = init_cache(model.cfg, B, smax, device="cpu")
    last, cache = prefill(model, torch.from_numpy(tokens[:, :prompt]).long(),
                          cache, **_torch_stubs(stubs))
    return last, cache


def _token(tokens, pos):
    return torch.from_numpy(tokens[:, pos:pos + 1]).long()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(runs, arch):
    model, tokens, stubs, ref, _ = runs[arch]
    last, cache = _port_prefill(model, tokens, stubs)
    want_last, want_cache = ref["prefill"]
    assert last.shape == (B, 1, model.cfg.vocab_padded)
    _close(last.numpy(), want_last, MODEL_TOL, "prefill logits")
    _same_tree(convert.cache_arrays(cache), want_cache, MODEL_TOL,
               "cache after prefill")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(runs, arch):
    """Each step's logits and the whole cache after it; the position is
    an int on even steps and a 0-d int32 tensor on odd ones."""
    model, tokens, stubs, ref, _ = runs[arch]
    prompt = _prompt(arch)[0]
    _, cache = _port_prefill(model, tokens, stubs)
    for t, (want_logits, want_cache) in enumerate(ref["steps"]):
        pos = _at(model.cfg, prompt + t)
        logits, cache = decode_step(
            model, _token(tokens, prompt + t), cache,
            pos if t % 2 == 0 else torch.tensor(pos, dtype=torch.int32))
        _close(logits.numpy(), want_logits, MODEL_TOL, f"step {t} logits")
        _same_tree(convert.cache_arrays(cache), want_cache, MODEL_TOL,
                   f"cache after step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_ports_forward(runs, arch):
    """The prefill's last logits and every decode step's are the
    full-sequence forward's at the same tokens (the caches are exact,
    not approximations)."""
    model, tokens, stubs, _, _ = runs[arch]
    prompt = _prompt(arch)[0]
    full = forward(model, torch.from_numpy(tokens).long(),
                   **_torch_stubs(stubs))[0].numpy()
    last, cache = _port_prefill(model, tokens, stubs)
    _close(last[:, 0].numpy(), full[:, prompt - 1], DECODE_TOL, "prefill")
    for t in range(prompt, prompt + STEPS):
        logits, cache = decode_step(model, _token(tokens, t), cache,
                                    _at(model.cfg, t))
        _close(logits[:, 0].numpy(), full[:, t], DECODE_TOL, f"token {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_cache_decodes_on_the_port(runs, arch):
    """The reference's cache after its prefill, carried into the port,
    decodes to the reference's own step logits."""
    model, tokens, _, ref, _ = runs[arch]
    prompt = _prompt(arch)[0]
    cache = convert.cache_from_arrays(ref["prefill"][1], model.cfg,
                                      device="cpu")
    for t, (want_logits, _) in enumerate(ref["steps"]):
        logits, cache = decode_step(model, _token(tokens, prompt + t), cache,
                                    _at(model.cfg, prompt + t))
        _close(logits.numpy(), want_logits, MODEL_TOL, f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_port_cache_decodes_on_the_reference(runs, arch):
    """The port's cache after its prefill, carried into the reference,
    decodes there to the port's own step logits."""
    model, tokens, stubs, _, jdecode = runs[arch]
    prompt = _prompt(arch)[0]
    _, cache = _port_prefill(model, tokens, stubs)
    jcache = jax.tree.map(jnp.asarray, convert.cache_arrays(cache))
    for t in range(prompt, prompt + STEPS):
        pos = _at(model.cfg, t)
        logits, cache = decode_step(model, _token(tokens, t), cache, pos)
        jlogits, jcache = jdecode(jcache, tokens[:, t:t + 1], pos)
        _close(jlogits, logits.numpy(), MODEL_TOL, f"token {t}")


@pytest.mark.parametrize("arch", ["gemma-7b", "mamba2-130m", "phi3-mini-3.8b",
                                  "granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "recurrentgemma-2b",
                                  "whisper-medium", "pixtral-12b"])
def test_init_cache_is_the_references_layout(arch):
    """Leaf paths, shapes and dtypes of the published configs' caches
    (the port's on the meta device, the reference's by eval_shape: no
    memory)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    want = jax.eval_shape(lambda: jtf.init_cache(jcfg, 3, 40))
    got = init_cache(cfg, 3, 40, device="meta")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in g:
            assert sorted(g[name]) == sorted(w[name])
            for key, t in g[name].items():
                assert tuple(t.shape) == w[name][key].shape
                assert str(t.dtype).removeprefix("torch.") == \
                    str(w[name][key].dtype)


def test_cache_from_arrays_refuses_a_wrong_shape():
    cfg = get_config("gemma-7b", reduced=True)
    tree = convert.cache_arrays(init_cache(cfg, 2, 8, device="cpu"))
    tree[0]["b0"]["v"] = tree[0]["b0"]["v"][:, :, :, :4]
    with pytest.raises(ValueError, match="b0/v"):
        convert.cache_from_arrays(tree, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the score paths at a query offset, with and without a window
# ---------------------------------------------------------------------------

def _qkv(seed, Sq, Sk, dtype, H=4, Hkv=2, hd=32):
    q = _np(seed, 1, H, Sq, hd, scale=0.5)
    k = _np(seed + 1, 1, Hkv, Sk, hd, scale=0.5)
    v = _np(seed + 2, 1, Hkv, Sk, hd)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([torch.from_numpy(a).to(dtype) for a in (q, k, v)],
            [jnp.asarray(a).astype(jdt) for a in (q, k, v)])


def _out(got, want, dtype):
    assert got.dtype == dtype
    _close(got.float().numpy(), np.asarray(want, np.float32),
           ATTN_TOL[dtype], "attention")


DTYPES = [torch.float32, torch.bfloat16]
WINDOWS = [None, 7]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_einsum_attn_matches_reference(dtype, window):
    (q, k, v), (jq, jk, jv) = _qkv(60, 6, 40, dtype)
    got = attn._einsum_attn(q, k, v, True, window, 30)
    _out(got, jattn._einsum_attn(jq, jk, jv, True, window, 30), dtype)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_attn_matches_reference(dtype, window):
    """Sk = 3,000 > _EINSUM_MAX_S: two full chunks and a ragged one."""
    Sk = 3000
    assert Sk > attn._EINSUM_MAX_S and Sk % attn.CHUNK
    (q, k, v), (jq, jk, jv) = _qkv(70, 5, Sk, dtype)
    got = attn._chunked_attn(q, k, v, True, window, Sk - 8)
    _out(got, jattn._chunked_attn(jq, jk, jv, True, window, Sk - 8), dtype)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos0", [0, 25])
def test_decode_attn_delta_matches_reference(dtype, window, pos0):
    (q, kc, vc), (jq, jkc, jvc) = _qkv(80, 1, 40, dtype)
    (_, kn, vn), (_, jkn, jvn) = _qkv(90, 1, 1, dtype)
    got = attn._decode_attn_delta(q, kc, vc, kn, vn, pos0, window)
    want = jattn._decode_attn_delta(jq, jkc, jvc, jkn, jvn, pos0, window)
    _out(got, want, dtype)
    tensor_pos = attn._decode_attn_delta(q, kc, vc, kn, vn,
                                         torch.tensor(pos0), window)
    assert torch.equal(tensor_pos, got)


def _dispatched(monkeypatch, Sq, Sk, offset, causal, window=None):
    """The path ``sdpa`` takes, and the arguments it passes it."""
    taken = []
    for name, tag in (("flash_attention_xla", "kernel"),
                      ("_einsum_attn", "einsum"),
                      ("_chunked_attn", "chunked")):
        monkeypatch.setattr(attn, name,
                            lambda *a, tag=tag: taken.append((tag, a)))
    q, k = torch.zeros(1, 2, Sq, 8), torch.zeros(1, 2, Sk, 8)
    offset = torch.tensor(0) if offset == "tensor" else offset
    attn.sdpa(q, k, k, causal=causal, window=window, q_offset=offset)
    assert len(taken) == 1
    return taken[0]


@pytest.mark.parametrize("Sq,Sk,offset,causal,path", [
    (16, 16, 0, True, "kernel"),
    (8, 16, 0, False, "kernel"),
    (8, 16, 0, True, "einsum"),        # the kernel aligns the mask apart
    (4, 16, 12, True, "einsum"),
    (1, 4000, 3999, True, "einsum"),
    (4, 3000, 2996, True, "chunked"),
    (16, 16, "tensor", True, "einsum"),  # a tensor offset is not read
])
def test_sdpa_dispatch(monkeypatch, Sq, Sk, offset, causal, path):
    assert _dispatched(monkeypatch, Sq, Sk, offset, causal)[0] == path


@pytest.mark.parametrize("Sq,Sk,offset,causal,window,path", [
    # a window masks nothing where every row's keys are within it
    (16, 16, 0, True, 16, "kernel"),
    (2048, 2048, 0, True, 2048, "kernel"),
    (8, 40, 0, False, 8, "kernel"),
    (17, 17, 0, True, 16, "einsum"),
    (4096, 4096, 0, True, 2048, "chunked"),
    (4, 16, 12, True, 64, "einsum"),    # an offset: the plain paths
    (1, 40, 39, True, 64, "einsum"),
])
def test_sdpa_dispatch_with_a_window(monkeypatch, Sq, Sk, offset, causal,
                                     window, path):
    """A window that masks nothing (offset 0, Sq - 1 < window) takes the
    flash kernel as if there were none; the plain paths keep it."""
    tag, args = _dispatched(monkeypatch, Sq, Sk, offset, causal, window)
    assert tag == path
    if path != "kernel":
        assert args[4] == window


def test_vacuous_window_computes_the_windowed_function():
    """Where the window masks nothing, the flash path's output is the
    windowed einsum's (the reference's path for a window), float32; one
    row past it, the window changes the output."""
    (q, k, v), _ = _qkv(95, 24, 24, torch.float32)
    for window in (24, 100):
        _close(attn.sdpa(q, k, v, causal=True, window=window).numpy(),
               attn._einsum_attn(q, k, v, True, window, 0).numpy(),
               ATTN_TOL[torch.float32], f"window {window}")
    past = attn.sdpa(q, k, v, causal=True, window=23)
    assert not torch.allclose(past, attn.sdpa(q, k, v, causal=True),
                              **ATTN_TOL[torch.float32])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _port_config(jcfg):
    """The reference's config rebuilt from the port's config classes,
    field by field."""
    def conv(v):
        if isinstance(v, enum.Enum):
            return pconfig.BlockKind(v.value)
        if dataclasses.is_dataclass(v):
            return getattr(pconfig, type(v).__name__)(**{
                f.name: conv(getattr(v, f.name))
                for f in dataclasses.fields(v)})
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v
    return conv(jcfg)


@pytest.mark.parametrize("arch", list_archs())
def test_is_subquadratic_matches_reference(arch):
    for reduced in (False, True):
        jcfg = jget_config(arch, reduced=reduced)
        assert _port_config(jcfg).is_subquadratic() == \
            jcfg.is_subquadratic()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-medium",
                                  "pixtral-12b"])
def test_new_family_configs_equal_the_references(arch):
    """The port's config of the RG-LRU hybrid, the encoder-decoder and
    the VLM (the archs whose caches the port once refused) is the
    reference's, field by field, published and reduced, and its reduced
    cache is ``jax.eval_shape`` of the reference's, leaf for leaf."""
    for reduced in (False, True):
        jcfg = jget_config(arch, reduced=reduced)
        assert get_config(arch, reduced=reduced) == _port_config(jcfg)
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    want = jax.eval_shape(lambda: jtf.init_cache(jcfg, 2, 24))
    got = init_cache(cfg, 2, 24, device="cpu")
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    for g, w in zip(got, want):
        for name in g:
            assert sorted(g[name]) == sorted(w[name])
            for key, t in g[name].items():
                assert tuple(t.shape) == w[name][key].shape
                assert str(t.dtype).removeprefix("torch.") == \
                    str(w[name][key].dtype)
                assert not t.any()
