"""The port's Mixture-of-Experts MLP against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through
``repro.models.moe.moe_mlp`` and ``repro_torch.models.moe.moe_mlp`` at
the reduced granite-moe-1b-a400m (routed experts only) and
deepseek-v2-lite-16b (shared experts too) configs, in float32, with the
reference's ``init_moe`` weights carried across.  At ``capacity_factor`` 8.0 no token drops; at 1.0 some do and
fall back to the residual path, and the port drops the same ones.
Tolerances: output, balance loss and every gradient rtol = atol = 1e-4
(the model tolerance of ``test_torch_models.py``); routing (experts,
slots, drops) equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import count_params as jcount_params  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import cut_depth  # noqa: E402
from repro_torch.models import count_params, init_params  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import BlockKind  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"]
B, S = 2, 24


def _configs(arch, capacity_factor):
    """(reference config, port config) reduced, at ``capacity_factor``."""
    out = []
    for cfg in (jget_config(arch, reduced=True),
                get_config(arch, reduced=True)):
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor)))
    return out


def _carry(jp, cfg):
    """The reference's ``init_moe`` tree -> the port's ``MoE`` module."""
    m = moe.MoE(cfg, device="cpu")
    with torch.no_grad():
        for name, t in m.named_parameters():
            leaf = jp
            for k in name.split("."):
                leaf = leaf[k]
            t.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return m


def _case(arch, capacity_factor, seed=0):
    jcfg, cfg = _configs(arch, capacity_factor)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jcfg, jp, cfg, _carry(jp, cfg), x


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_reference(arch, capacity_factor):
    """Output and balance loss; at capacity 8 nothing drops, at 1 some
    choices do (asserted) and the port's output is the reference's all
    the same."""
    jcfg, jp, cfg, m, x = _case(arch, capacity_factor)
    want, want_aux = jmoe.moe_mlp(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_mlp(m, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MODEL_TOL)
    r = moe.route(m.router, cfg, torch.from_numpy(x).reshape(-1,
                                                             cfg.d_model))
    dropped = int((~r.keep).sum())
    assert r.capacity == int(capacity_factor * B * S * cfg.moe.top_k
                             / cfg.moe.n_experts) + 1
    if capacity_factor >= cfg.moe.n_experts / cfg.moe.top_k:
        assert dropped == 0
    else:
        assert dropped > 0
    # the same drops as the reference's ranks, computed here in numpy
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, cfg.d_model))
                           @ jp["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, cfg.moe.top_k)
    e_row = np.asarray(top_e).reshape(-1)
    rank = np.array([np.sum(e_row[:i] == e) for i, e in enumerate(e_row)])
    np.testing.assert_array_equal(r.keep.numpy(), rank < r.capacity)
    np.testing.assert_array_equal(r.top_e.numpy(), np.asarray(top_e))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_gradient_matches_reference(arch):
    """The gradient of the output (under a random cotangent) plus the
    balance loss, in x and every parameter, with tokens dropped
    (capacity 1): against ``jax.vjp`` of the reference's ``moe_mlp``."""
    jcfg, jp, cfg, m, x = _case(arch, 1.0, seed=3)
    dy = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_mlp(p, jcfg, xx)
        return jnp.sum(y * dy) + aux
    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    params = dict(m.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    y, aux = moe.moe_mlp(m, cfg, xt)
    loss = torch.sum(y * torch.from_numpy(dy)) + aux
    grads = torch.autograd.grad(loss, [xt, *params.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_x),
                               err_msg="x", **MODEL_TOL)
    for (name, _), g in zip(params.items(), grads[1:]):
        leaf = want_p
        for k in name.split("."):
            leaf = leaf[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(leaf),
                                   err_msg=name, **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_rows_route_to_the_first_experts(arch):
    """A zero row's probabilities are all equal: jax.lax.top_k puts the
    lower index first, so it routes to experts 0 .. K-1 (a plain
    torch.topk promises no order among equals); its ranks follow token
    order (the stable sort), so the first C zero rows keep expert 0's
    slots 0 .. C-1 and the rest drop."""
    _, cfg = _configs(arch, 1.0)
    K, E = cfg.moe.top_k, cfg.moe.n_experts
    router = torch.randn((cfg.d_model, E), generator=torch.Generator()
                         .manual_seed(0))
    xf = torch.zeros((40, cfg.d_model))
    r = moe.route(router, cfg, xf)
    assert torch.equal(r.top_e, torch.arange(K).expand(40, K))
    np.testing.assert_array_equal(
        r.top_e.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(
            r.probs.numpy()), K)[1]))
    C = r.capacity
    slot = r.slot.view(40, K)
    assert torch.equal(slot[:C, 0], torch.arange(C))
    assert bool((slot[C:] == E * C).all()) and int(r.keep.sum()) == C * K
    np.testing.assert_allclose(r.top_w.numpy(), 1.0 / K, rtol=1e-6)


def test_balance_loss_is_the_switch_loss():
    """E * sum_e (mean probability of e) (share of the choices of e),
    the share from integer counts: with uniform probabilities every
    token chooses experts 0 .. K-1, and the loss is E * K / (E K) = 1."""
    _, cfg = _configs("granite-moe-1b-a400m", 8.0)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    r = moe.route(torch.zeros((cfg.d_model, E)), cfg,
                  torch.zeros((8, cfg.d_model)))
    assert torch.equal(r.top_e, torch.arange(K).expand(8, K))
    assert float(moe.balance_loss(r, E)) == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_are_the_references(arch):
    """Published and reduced: the same fields as the reference's, the
    same parameter count; the published configs at their published
    widths (granite 24 x 1,024, 32 experts top-8; deepseek 27 x 2,048,
    64 experts top-6, two shared, a dense first block)."""
    for reduced in (False, True):
        mine = get_config(arch, reduced=reduced)
        theirs = jget_config(arch, reduced=reduced)
        assert dataclasses.asdict(mine.moe) == dataclasses.asdict(theirs.moe)
        assert (mine.name, mine.d_model, mine.n_layers, mine.vocab,
                mine.tie_embeddings) == (theirs.name, theirs.d_model,
                                         theirs.n_layers, theirs.vocab,
                                         theirs.tie_embeddings)
        assert [(s.repeat, s.moe, [k.value for k in s.kinds])
                for s in mine.segments] == [
            (s.repeat, s.moe, [k.value for k in s.kinds])
            for s in theirs.segments]
        assert count_params(mine) == jcount_params(theirs)
    cfg = get_config(arch)
    if arch.startswith("granite"):
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.hd, cfg.moe.n_experts, cfg.moe.top_k) == (
            24, 1024, 16, 8, 64, 32, 8)
    else:
        assert (cfg.n_layers, cfg.d_model, cfg.moe.n_experts,
                cfg.moe.top_k, cfg.moe.n_shared, cfg.mla.kv_lora) == (
            27, 2048, 64, 6, 2, 512)
        assert [s.moe for s in cfg.segments] == [False, True]


def test_cut_depth_across_segments():
    """deepseek's dense block and then its MoE blocks, in order: 1 block
    is the dense one, 3 the dense one and two MoE blocks, the whole
    depth the config; empty segments dropped; a cut inside a unit and
    depths outside 1 .. n_layers refused."""
    cfg = get_config("deepseek-v2-lite-16b")
    one, three = cut_depth(cfg, 1), cut_depth(cfg, 3)
    assert [(s.repeat, s.moe) for s in one.segments] == [(1, False)]
    assert [(s.repeat, s.moe) for s in three.segments] == [(1, False),
                                                          (2, True)]
    assert cut_depth(cfg, 27) == cfg and cut_depth(cfg, None) is cfg
    for bad in (0, 28):
        with pytest.raises(ValueError, match="layers"):
            cut_depth(cfg, bad)
    unit2 = dataclasses.replace(cfg, segments=(
        dataclasses.replace(cfg.segments[0], kinds=(BlockKind.MLA,) * 2,
                            repeat=2),))
    with pytest.raises(ValueError, match="unit"):
        cut_depth(unit2, 3)
    assert cut_depth(unit2, 2).segments[0].repeat == 1
    assert count_params(three) < count_params(cfg)


def test_moe_init_draws_the_reference_distributions():
    """router float32 whatever the param dtype, normal / sqrt(d); w_gate
    and w_up normal / sqrt(E) (the reference's ``he_init`` takes the
    first dimension of the (E, d, f) stack); w_down normal / sqrt(f)."""
    cfg = get_config("deepseek-v2-lite-16b", reduced=True)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    blk = model.segments[1][0]
    assert blk.moe.router.dtype == torch.float32
    assert blk.moe.w_gate.dtype == torch.bfloat16
    E, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
    for w, fan_in in ((blk.moe.router, cfg.d_model), (blk.moe.w_gate, E),
                      (blk.moe.w_up, E), (blk.moe.w_down, f)):
        assert abs(float(w.float().std()) * fan_in ** 0.5 - 1.0) < 0.1
    assert blk.moe.shared.w_up.shape == (cfg.d_model, cfg.moe.d_ff_shared)
    assert not hasattr(model.segments[0][0], "moe")
