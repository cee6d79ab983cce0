"""The port's RG-LRU block against the JAX reference.

The same numpy inputs, made from a seed, go through
``repro.models.rglru`` and ``repro_torch.models.rglru`` on the CPU, the
reference's weights (``init_rglru``) copied into the port's ``RGLRU``.
Tolerances, float32: rtol = atol = 1e-5 for the block and the scan (the
two frameworks multiply the scan's pairs in their own tree order), 1e-4
for the gradients and for the reduced recurrentgemma-2b model's logits,
loss and gradients (the model tolerance of ``test_torch_models.py``).
Its decode past the window is in ``test_torch_decode.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import (Transformer, forward, load_param_tree,  # noqa: E402
                                param_tree, value_and_grad)
from repro_torch.models import rglru  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "recurrentgemma-2b"


def _np(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def block():
    """(reference config, reference params as numpy, the port's RGLRU
    holding them) at the reduced width (d = w = 128, conv width 4)."""
    jcfg = jget_config(ARCH, reduced=True)
    jp = jax.tree.map(np.asarray,
                      jrglru.init_rglru(jax.random.PRNGKey(3), jcfg))
    mod = rglru.RGLRU(get_config(ARCH, reduced=True), device="cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            leaf = jp
            for k in name.split("."):
                leaf = leaf[k]
            p.copy_(torch.from_numpy(np.array(leaf)))
    return jcfg, jp, mod


def _state(jcfg, B, seed):
    w = jcfg.rglru.lru_width
    return {"conv": _np(seed, B, jcfg.rglru.d_conv - 1, w),
            "h": _np(seed + 1, B, w)}


@pytest.mark.parametrize("S", [1, 9, 70])
def test_rglru_block_matches_reference(block, S):
    jcfg, jp, mod = block
    x = _np(S, 2, S, jcfg.d_model)
    want, none = jrglru.rglru_block(jp, jcfg, jnp.asarray(x))
    assert none is None
    _close(mod(torch.from_numpy(x)).detach().numpy(), want, TOL, "out")


@pytest.mark.parametrize("S", [1, 9, 70])
def test_rglru_block_with_state_matches_reference(block, S):
    """A stateful call continues from the carried conv state and h and
    returns the new ones (h of the last step, float32)."""
    jcfg, jp, mod = block
    x = _np(40 + S, 2, S, jcfg.d_model)
    st = _state(jcfg, 2, 50 + S)
    want, wst = jrglru.rglru_block(jp, jcfg, jnp.asarray(x), state={
        k: jnp.asarray(a) for k, a in st.items()})
    got, gst = rglru.rglru_block(mod, mod.cfg, torch.from_numpy(x), state={
        k: torch.from_numpy(a) for k, a in st.items()})
    _close(got.detach().numpy(), want, TOL, "out")
    assert sorted(gst) == sorted(wst) == ["conv", "h"]
    assert gst["h"].dtype == torch.float32
    for k in gst:
        _close(gst[k].detach().numpy(), wst[k], TOL, k)


def test_split_sequence_continues_the_state(block):
    """The sequence in two calls through the state is the sequence in
    one (the cache's premise)."""
    jcfg, _, mod = block
    x = torch.from_numpy(_np(60, 2, 23, jcfg.d_model))
    zero = {k: torch.zeros_like(torch.from_numpy(a))
            for k, a in _state(jcfg, 2, 0).items()}
    whole = mod(x).detach()
    a, st = rglru.rglru_block(mod, mod.cfg, x[:, :15], state=zero)
    b, _ = rglru.rglru_block(mod, mod.cfg, x[:, 15:], state=st)
    _close(torch.cat([a, b], 1).detach().numpy(), whole.numpy(), TOL,
           "split")


def _comb(l, r):
    """The reference's combine (``src/repro/models/rglru.py:65``)."""
    al, bl = l
    ar, br = r
    return al * ar, br + ar * bl


@pytest.mark.parametrize("S", [1, 2, 3, 8, 63, 64, 100])
def test_linear_scan_matches_associative_scan(S):
    """h_t = a_t h_{t-1} + b_t: the port's doubling scan against the
    reference's ``jax.lax.associative_scan`` of the same pairs and a
    float64 loop, a in (0, 1) as the RG-LRU's."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.05, 1.0, (2, S, 24)).astype(np.float32)
    b = rng.standard_normal((2, S, 24)).astype(np.float32)
    _, want = jax.lax.associative_scan(
        _comb, (jnp.asarray(a).swapaxes(0, 1), jnp.asarray(b).swapaxes(0, 1)),
        axis=0)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got.numpy(), np.asarray(want).swapaxes(0, 1), TOL, "scan")
    h, loop = np.zeros((2, 24)), np.zeros((2, S, 24))
    for t in range(S):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        loop[:, t] = h
    _close(got.numpy(), loop, TOL, "loop")


def test_rglru_block_gradient_matches_jax_vjp(block):
    """The block's gradient in its input, every weight and lam, through
    autograd of the plain scan, against ``jax.vjp`` of the reference's
    block with the same cotangent."""
    jcfg, jp, mod = block
    x = _np(70, 2, 33, jcfg.d_model)
    ct = _np(71, 2, 33, jcfg.d_model)
    _, vjp = jax.vjp(lambda p, xx: jrglru.rglru_block(p, jcfg, xx)[0],
                     jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    named = list(mod.named_parameters())
    for _, p in named:
        p.requires_grad_(True)
    try:
        out = mod(xt)
        grads = torch.autograd.grad(out, [xt] + [p for _, p in named],
                                    torch.from_numpy(ct))
    finally:
        for _, p in named:
            p.requires_grad_(False)
    _close(grads[0].numpy(), gx, GRAD_TOL, "dx")
    for (name, _), g in zip(named, grads[1:]):
        leaf = gp
        for k in name.split("."):
            leaf = leaf[k]
        _close(g.numpy(), leaf, GRAD_TOL, name)


def test_lam_stays_float32_in_a_bf16_model():
    """lam is float32 in the bf16 model (the reference's
    ``.astype(jnp.float32)``), built so and kept so by
    ``load_param_tree``'s rounding to each parameter's dtype, bitwise;
    the other leaves are bf16."""
    meta = Transformer(get_config(ARCH), device="meta")
    blk = meta.segments[0][0].rglru
    assert blk.lam.dtype == torch.float32 and blk.w_x.dtype == torch.bfloat16
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = Transformer(cfg, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    tree = param_tree(model)
    lam = tree["segments"][0]["b0"]["rglru"]["lam"]
    assert lam.dtype == torch.float32 and lam.shape == (2, 128)
    tree["segments"][0]["b0"]["rglru"]["lam"] = lam + 1e-3
    load_param_tree(model, tree)
    got = model.segments[0][0].rglru.lam
    assert got.dtype == torch.float32
    assert torch.equal(got, lam[0] + 1e-3)
    want = jrglru.init_rglru(jax.random.PRNGKey(0),
                             jget_config(ARCH, reduced=True))["lam"]
    _close(got - 1e-3, want, TOL, "reset_parameters' lam")


def test_softplus_at_lams_values():
    """jax.nn.softplus is log(1 + e^x) everywhere; ``F.softplus`` turns
    into the identity above its threshold of 20.  At lam's values (a^c
    in (0.9, 0.999): lam in about (-9.0, -4.3)) the two agree, and the
    port's ``softplus`` is jax's at any value."""
    lam = np.array(jrglru.init_rglru(
        jax.random.PRNGKey(0), jget_config(ARCH))["lam"])
    assert -9.1 < lam.min() and lam.max() < -4.2
    want = np.asarray(jax.nn.softplus(jnp.asarray(lam)))
    t = torch.from_numpy(lam)
    _close(rglru.softplus(t).numpy(), want, dict(rtol=1e-6, atol=0), "port")
    _close(F.softplus(t).numpy(), want, dict(rtol=1e-6, atol=0), "F")
    wide = np.array([-30.0, 0.0, 19.0, 25.0], np.float32)
    _close(rglru.softplus(torch.from_numpy(wide)).numpy(),
           jax.nn.softplus(jnp.asarray(wide)), dict(rtol=1e-6, atol=0),
           "past F.softplus's threshold")


@pytest.fixture(scope="module")
def hybrid():
    """(reference config, reference params, port model) of reduced
    recurrentgemma-2b: 2 units of (RG-LRU, RG-LRU, local attention of
    window 64)."""
    jcfg = jget_config(ARCH, reduced=True)
    jp = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(5), jcfg)
    return jcfg, jp, convert.model_params_from_arrays(
        jax.tree.map(np.asarray, jp), get_config(ARCH, reduced=True),
        device="cpu")


@pytest.mark.parametrize("S", [40, 80])
def test_hybrid_model_loss_and_gradients_match_reference(hybrid, S):
    """Logits, loss and every gradient leaf of the reduced hybrid against
    ``jax.value_and_grad`` of the reference's ``loss_fn``: at 40 tokens
    the window masks nothing (the flash path), at 80 it does (the plain
    windowed path)."""
    jcfg, jp, model = hybrid
    tokens = np.random.default_rng(S).integers(
        0, jcfg.vocab, (2, S + 1)).astype(np.int32)
    toks, labels = tokens[:, :-1], tokens[:, 1:]
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(toks))
    got, _ = forward(model, torch.from_numpy(toks).long())
    _close(got.numpy(), want, GRAD_TOL, "logits")
    jl, jg = jax.value_and_grad(lambda p: jloss_fn(
        p, jcfg, jnp.asarray(toks), jnp.asarray(labels)))(jp)
    loss, grads = value_and_grad(model, torch.from_numpy(toks).long(),
                                 torch.from_numpy(labels).long())
    _close(float(loss), float(jl), GRAD_TOL, "loss")
    mine = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), grads))[0]
    theirs = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    assert sorted(map(str, dict(mine))) == sorted(map(str, theirs))
    for path, g in mine:
        _close(g, theirs[path], GRAD_TOL, jax.tree_util.keystr(path))


def test_hybrid_trains_through_a_failure(capsys):
    """The training CLI trains reduced recurrentgemma-2b (cut to one unit
    by ``--layers 3``: the cut falls on whole units) through an injected
    failure."""
    stats = train.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                        "--layers", "3", "--steps", "8", "--batch", "2",
                        "--seq", "16", "--lr", "3e-3", "--ckpt-every", "3",
                        "--fail-at", "5"])
    assert stats.restarts == 1 and stats.steps_run == 10
    assert "arch=recurrentgemma-2b-reduced" in capsys.readouterr().out
    with pytest.raises(ValueError, match="cuts a unit"):
        train.cut_depth(get_config(ARCH), 4)
