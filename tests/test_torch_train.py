"""The port's training path against the JAX reference, on the CPU.

Reduced mamba2; for the dense family, reduced gemma-7b (GeGLU, tied
head, softcap) and reduced mistral-nemo-12b (GQA 4/2, SwiGLU, untied
head); for the MoE family, reduced granite-moe-1b-a400m and
deepseek-v2-lite-16b (MLA, shared experts, two segments); each float32
with 2 or 3 layers, with the reference's weights carried across by
``convert.py``: ``loss_fn`` and every gradient leaf against
``jax.value_and_grad(repro.models.loss_fn)`` (the reference's plain scan
or attention differentiated by JAX; the port's plain forward and its
plain SSD recurrence or flash backward), five optimizer steps' losses
against the reference's train step, the fault-tolerant loop's restart
trajectory bitwise an uninterrupted run, a training checkpoint written
by each side and restored by the other, and the training CLI surviving
an injected failure.  Tolerances: loss rtol 1e-5, gradients rtol = atol
= 1e-4 (the same float32 functions, summed in other orders), five
steps' losses rtol 1e-4; the restart and the checkpoints BITWISE.
"""
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.checkpoint import save as jsave  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.checkpoint import checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import PipelineState, TokenPipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import (check_trainable, init_params,  # noqa: E402
                                loss_fn, param_tree, value_and_grad)
from repro_torch.optim import OptState  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.runtime import FaultConfig, WorkerFailure, run  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mamba2-130m"
DENSE_ARCHS = ["gemma-7b", "mistral-nemo-12b"]
# routed experts with GQA and a tied head; MLA, a dense block and then MoE
# with shared experts, an untied head
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"]


def _carry(arch):
    """The reference's reduced weights of ``arch``, in both packages."""
    jcfg = jget_config(arch, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(arch, reduced=True)
    model = convert.model_params_from_arrays(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, model


@pytest.fixture(scope="module")
def carried():
    """The reference's reduced mamba2 weights, in both packages."""
    return _carry(ARCH)


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def dense(request):
    """A reduced dense config's reference weights, in both packages."""
    return _carry(request.param)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe(request):
    """A reduced MoE config's reference weights, in both packages."""
    return _carry(request.param)


def _batch(cfg, seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    return toks[:, :-1], toks[:, 1:]


def _by_path(tree):
    """{jax key path: float32 numpy leaf} of a jax or numpy tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k) for k in p): np.asarray(v, np.float32)
            for p, v in flat}


def test_loss_and_every_gradient_leaf_match_the_reference(carried):
    _check_loss_and_grads(carried)


def test_dense_loss_and_every_gradient_leaf_match_the_reference(dense):
    """The attention blocks' gradient through the flash backward's plain
    version, the tied head's (gemma) and the untied one's (mistral)."""
    _check_loss_and_grads(dense)


def test_moe_loss_and_every_gradient_leaf_match_the_reference(moe):
    """The loss with 0.01 x the balance loss of every MoE block, and every
    leaf of its gradient -- the router's (through the top-k weights and
    the balance loss), each expert stack's, the shared experts' and
    MLA's -- against ``jax.value_and_grad(repro.models.loss_fn)``."""
    _check_loss_and_grads(moe)


def _check_loss_and_grads(carried):
    jcfg, jp, cfg, model = carried
    tokens, labels = _batch(cfg, 1)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, jnp.asarray(tokens),
                           jnp.asarray(labels)))(jp)
    loss, grads = value_and_grad(model, torch.from_numpy(tokens),
                                 torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = _by_path(jax.tree.map(lambda t: t.numpy(), grads))
    want = _by_path(want_grads)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **GRAD_TOL)
    # the gradient came through the model, which stays frozen for serving
    assert not any(p.requires_grad for p in model.parameters())
    assert float(loss_fn(model, torch.from_numpy(tokens),
                         torch.from_numpy(labels))) == float(loss)


def test_parameters_carry_back_to_the_reference_tree(carried):
    """``convert.model_arrays`` is the inverse of
    ``model_params_from_arrays``: the reference's tree, leaf paths and
    bits."""
    _check_carry_back(carried)


def test_dense_parameters_carry_back_to_the_reference_tree(dense):
    _check_carry_back(dense)


def test_moe_parameters_carry_back_to_the_reference_tree(moe):
    """The expert stacks (R, E, d, f), the float32 router and MLA's
    weights, both segments of deepseek's."""
    _check_carry_back(moe)


def _check_carry_back(carried):
    _, jp, _, model = carried
    got, want = _by_path(convert.model_arrays(model)), _by_path(jp)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_five_optimizer_steps_match_the_reference(carried):
    _check_five_steps(carried)


def test_dense_five_optimizer_steps_match_the_reference(dense):
    _check_five_steps(dense)


def test_moe_five_optimizer_steps_match_the_reference(moe):
    _check_five_steps(moe)


def _check_five_steps(carried):
    jcfg, jp, cfg, _ = carried
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    jopt = joptim.AdamWConfig(**opt)

    @jax.jit
    def jstep(p, s, t, lab):
        loss, g = jax.value_and_grad(
            lambda q: jloss_fn(q, jcfg, t, lab))(p)
        p, s, _ = joptim.update(jopt, g, s, p)
        return p, s, loss

    model = convert.model_params_from_arrays(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")
    step = train.make_step(model, optim.AdamWConfig(**opt))
    params = param_tree(model)
    state = (params, optim.init(params))
    jstate = (jp, joptim.init(jp))
    jpipe = JTokenPipeline(cfg.vocab, 2, 16, seed=3)
    pipe = TokenPipeline(cfg.vocab, 2, 16, seed=3, device="cpu")
    got, want = [], []
    for _ in range(5):
        state, loss = step(state, next(pipe))
        got.append(float(loss))
        t, lab = next(jpipe)
        p, s, jl = jstep(*jstate, t, lab)
        jstate = (p, s)
        want.append(float(jl))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def _loop(tmp, fail_at, n=10, every=3):
    cfg = get_config(ARCH, reduced=True)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    params = param_tree(model)
    pipe = TokenPipeline(cfg.vocab, 2, 8, seed=1, device="cpu")
    stats = run(train.make_step(model, optim.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=n)),
        (params, optim.init(params)), pipe, n,
        FaultConfig(ckpt_every=every, ckpt_dir=str(tmp),
                    fail_at_steps=fail_at),
        pipeline_state_fn=lambda: pipe.state.to_dict(),
        restore_pipeline_fn=lambda d: pipe.restore(
            PipelineState.from_dict(d)))
    return stats


def _replayed(losses, fail_at, every):
    """The trajectory a run with failures records: at each failure the
    steps since the last checkpoint run again."""
    out, step, fails = [], 0, set(fail_at)
    while step < len(losses):
        if step in fails:
            fails.discard(step)
            step = step // every * every
            continue
        out.append(losses[step])
        step += 1
    return out


def test_loop_restart_replays_the_trajectory_bitwise(tmp_path):
    ref = _loop(tmp_path / "a", ())
    got = _loop(tmp_path / "b", (5, 8))
    assert got.restarts == 2 and ref.restarts == 0
    assert got.losses == _replayed(ref.losses, (5, 8), 3)
    assert checkpoint.latest_step(str(tmp_path / "b")) == 10


def test_loop_without_a_checkpoint_reraises(tmp_path):
    with pytest.raises(WorkerFailure):
        _loop(tmp_path, (1,), n=4, every=3)


def test_loop_refuses_a_config_without_its_checkpoint_dir():
    """A run resumes from whatever checkpoint its directory holds, so
    ``run`` takes no default directory (the reference's fixed one would
    resume a stale run)."""
    with pytest.raises(ValueError, match="ckpt_dir"):
        run(lambda s, b: (s, 0.0), {}, iter(()), 1, FaultConfig())


def _trained_state(carried, tmp_path):
    """One optimizer step on both sides from the same weights: (jax
    state, port state)."""
    jcfg, jp, cfg, model = carried
    tokens, labels = _batch(cfg, 2)
    jg = jax.grad(lambda p: jloss_fn(p, jcfg, jnp.asarray(tokens),
                                     jnp.asarray(labels)))(jp)
    jcfg_opt = joptim.AdamWConfig(warmup_steps=1, total_steps=3)
    jstate = jp, joptim.init(jp)
    jstate = joptim.update(jcfg_opt, jg, jstate[1], jstate[0])[:2]
    params = param_tree(model)
    _, g = value_and_grad(model, torch.from_numpy(tokens),
                          torch.from_numpy(labels))
    tstate = optim.update(optim.AdamWConfig(warmup_steps=1, total_steps=3),
                          g, optim.init(params), params)[:2]
    return jstate, tstate


def test_training_checkpoints_cross_restore(carried, tmp_path):
    """The reference's checkpoint of (params, OptState) restores into the
    port's state (a NamedTuple tree, which the port's checkpoint could not
    rebuild before) and the port's into the reference's: the same leaf
    paths, every leaf bitwise."""
    _check_cross_restore(carried, tmp_path)


@pytest.mark.parametrize("dense", ["gemma-7b"], indirect=True)
def test_dense_training_checkpoints_cross_restore(dense, tmp_path):
    """One dense config suffices: the leaf paths are the attention
    block's; the arithmetic is the other tests'."""
    _check_cross_restore(dense, tmp_path)


def _check_cross_restore(carried, tmp_path):
    jstate, tstate = _trained_state(carried, tmp_path)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsave(jdir, 1, jstate, extra={"pipeline": {"seed": 0, "step": 1}})
    checkpoint.save(tdir, 1, tstate, extra={"pipeline": {"seed": 0,
                                                         "step": 1}})
    paths = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "step_1", "manifest.json")) as f:
            paths.append([leaf["path"] for leaf in json.load(f)["leaves"]])
    assert paths[0] == paths[1]
    assert "[1]/.step" in paths[0] and "[1]/.mu/['embed']/['table']" in \
        paths[0]

    got, step, extra = checkpoint.restore(jdir, tstate)
    assert step == 1 and extra["pipeline"]["step"] == 1
    assert isinstance(got[1], OptState) and got[1].step.dtype == torch.int32
    for a, b in zip(leaves(got), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back, _, _ = jrestore(tdir, jstate)
    assert isinstance(back[1], joptim.OptState)
    for a, b in zip(jax.tree.leaves(back), leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_reference_opt_state_carries_into_the_port(carried, tmp_path):
    jstate, _ = _trained_state(carried, tmp_path)
    st = convert.opt_state_from_arrays(jax.tree.map(np.asarray, jstate[1]),
                                       device="cpu")
    assert int(st.step) == 1
    for a, b in zip(leaves(st.mu), jax.tree.leaves(jstate[1].mu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dense_configs_train(capsys):
    """What replaced the refusal this test held (``check_trainable``
    refused ATTN blocks before the flash backward): every ported arch's
    config trains, published and reduced; reduced gemma-7b's loss has a
    gradient in every parameter; and the training CLI trains it through
    an injected failure, cut to one block by ``--layers`` (the train
    path's depth cut) and at its two."""
    for arch in ("gemma-7b", "codeqwen1.5-7b", "phi3-mini-3.8b",
                 "mistral-nemo-12b", "mamba2-130m"):
        for reduced in (False, True):
            check_trainable(get_config(arch, reduced=reduced))
    cfg = get_config("gemma-7b", reduced=True)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    tokens = torch.arange(8, dtype=torch.int64).reshape(1, 8)
    loss, grads = value_and_grad(model, tokens, tokens)
    assert np.isfinite(float(loss))
    assert all(bool(g.abs().sum() > 0) for g in leaves(grads))
    for layers in (["--layers", "1"], []):
        stats = train.main(["--device", "cpu", "--arch", "gemma-7b",
                            "--reduced", "--steps", "10", "--batch", "2",
                            "--seq", "16", "--lr", "3e-3", "--ckpt-every",
                            "4", "--fail-at", "6", *layers])
        assert stats.restarts == 1 and stats.steps_run == 12
    assert "arch=gemma-7b-reduced" in capsys.readouterr().out
    with pytest.raises(ValueError, match="layers"):
        train.cut_depth(cfg, 3)


def test_train_cli_survives_an_injected_failure(capsys):
    stats = train.main(["--device", "cpu", "--reduced", "--steps", "14",
                        "--batch", "2", "--seq", "16", "--lr", "3e-3",
                        "--ckpt-every", "5", "--fail-at", "7"])
    assert stats.restarts == 1 and stats.steps_run == 16
    assert "restarts=1" in capsys.readouterr().out


def test_moe_train_cli_survives_an_injected_failure(capsys):
    """The MoE families train through the CLI: every MoE config passes
    ``check_trainable``, published and reduced, and reduced
    deepseek-v2-lite cut across its segments by ``--layers 2`` (its
    dense block and one MoE block) trains through a failure."""
    for arch in MOE_ARCHS:
        for reduced in (False, True):
            check_trainable(get_config(arch, reduced=reduced))
    stats = train.main(["--device", "cpu", "--arch", "deepseek-v2-lite-16b",
                        "--reduced", "--layers", "2", "--steps", "8",
                        "--batch", "2", "--seq", "16", "--lr", "3e-3",
                        "--ckpt-every", "3", "--fail-at", "5"])
    assert stats.restarts == 1 and stats.steps_run == 10
    assert "arch=deepseek-v2-lite-16b-reduced" in capsys.readouterr().out
