"""The port's optimizer, gradient compression and token pipeline against
the JAX reference, on the CPU.

The same numpy trees go through ``repro.optim`` and ``repro_torch.optim``.
Tolerances: AdamW's parameters, moments, schedule and grad norm within
rtol 1e-6 (the same float32 operations in the same order; only the
library ``pow``/``cos``/``sqrt`` and the sums' order may round an ulp
apart), bf16 parameters included (updated in float32, rounded once); the
int8 compression values and scales EQUAL (one float32 division, rounding
half to even); the token pipeline's batches EQUAL, at two vocab sizes and
two shards (the threefry bits, XLA-CPU's float32 log and argmax's first
maximum reproduced exactly).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import PipelineState, TokenPipeline  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.tree import (leaves, leaves_with_paths, tree_map,  # noqa: E402
                              unflatten)
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

RTOL = 1e-6


def _tree(seed, bf16=False):
    """A parameter-shaped tree: a dict with a stacked segment list, one
    leaf bf16 when asked."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": {"table": f(7, 4)},
            "segments": [{"b0": {"w": f(2, 4, 3), "s": f(2, 3)}}],
            "final": f(4).astype(np.float32) if not bf16 else
            np.asarray(jnp.asarray(f(4), jnp.bfloat16))}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        return torch.from_numpy(a.copy())
    return jax.tree.map(one, tree)


def _close(got, want, rtol=RTOL):
    got_l = [t.float().numpy() for t in leaves(got)]
    want_l = [np.asarray(a, np.float32) for a in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_update_matches_reference(bf16):
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    jcfg = joptim.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    params = _tree(0, bf16)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = joptim.init(jp), optim.init(tp)
    assert all(t.dtype == torch.float32 for t in leaves(ts.mu))
    for i in range(4):
        g = _tree(10 + i, bf16)
        jp, js, jm = joptim.update(jcfg, _to_jax(g), js, jp)
        tp, ts, tm = optim.update(cfg, _to_torch(g), ts, tp)
        _close(tp, jp)
        _close(ts.mu, js.mu)
        _close(ts.nu, js.nu)
        assert int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
    if bf16:
        assert tp["final"].dtype == torch.bfloat16


@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 55, 99, 100, 150])
def test_schedule_matches_reference(step):
    cfg = optim.AdamWConfig(lr=0.3, warmup_steps=10, total_steps=100)
    jcfg = joptim.AdamWConfig(lr=0.3, warmup_steps=10, total_steps=100)
    got = optim.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = joptim.schedule(jcfg, jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_clip_matches_reference():
    """Gradients far past clip_norm are scaled to it, as the reference
    scales them."""
    cfg = optim.AdamWConfig(lr=1.0, clip_norm=0.5, warmup_steps=10,
                            total_steps=100)
    jcfg = joptim.AdamWConfig(lr=1.0, clip_norm=0.5, warmup_steps=10,
                              total_steps=100)
    params = _tree(1)
    big = jax.tree.map(lambda a: a * 1e6, _tree(2))
    jp, js, _ = joptim.update(jcfg, _to_jax(big), joptim.init(
        _to_jax(params)), _to_jax(params))
    tp, ts, tm = optim.update(cfg, _to_torch(big), optim.init(
        _to_torch(params)), _to_torch(params))
    _close(tp, jp)
    _close(ts.mu, js.mu)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(
        joptim.global_norm(_to_jax(big))), rtol=RTOL)
    assert all(torch.isfinite(t).all() for t in leaves(tp))


def test_update_leaves_its_inputs_alone():
    params = _to_torch(_tree(3))
    state = optim.init(params)
    before = [t.clone() for t in leaves(params)]
    optim.update(optim.AdamWConfig(), _to_torch(_tree(4)), state, params)
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), before))
    assert all(not t.any() for t in leaves(state.mu))


def test_adamw_decreases_quadratic():
    """The reference's own convergence check, on the port."""
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = optim.init(params)
    for _ in range(100):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state, m = optim.update(cfg, {"w": g}, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_quantize_equals_reference(scale):
    g = (np.random.default_rng(5).standard_normal((33, 7)) * scale).astype(
        np.float32)
    q, s = compression.quantize(torch.from_numpy(g))
    jq, js = jcompression.quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s).view(np.uint32) == np.float32(js).view(np.uint32)
    np.testing.assert_array_equal(compression.dequantize(q, s).numpy(),
                                  np.asarray(jcompression.dequantize(jq, js)))


def test_compress_tree_equals_reference_over_steps():
    grads = [_tree(20 + i) for i in range(3)]
    ef = compression.init(_to_torch(grads[0]))
    jef = jcompression.init(_to_jax(grads[0]))
    for g in grads:
        qt, ef, recon = compression.compress_tree(_to_torch(g), ef)
        jqt, jef, jrecon = jcompression.compress_tree(_to_jax(g), jef)
        # the (q, scale) pairs flatten in the same order on both sides
        jq, tq = jax.tree.leaves(jqt), leaves(qt)
        assert len(tq) == len(jq)
        for a, b in zip(tq, jq):
            np.testing.assert_array_equal(np.asarray(a.numpy()),
                                          np.asarray(b))
        for a, b in zip(leaves(ef.residual), jax.tree.leaves(jef.residual)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(leaves(recon), jax.tree.leaves(jrecon)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [50, 50280])
@pytest.mark.parametrize("shard", [0, 3])
def test_pipeline_batches_equal_the_reference(vocab, shard):
    seq = 9 if vocab < 1000 else 3
    jp = JTokenPipeline(vocab, 2, seq, seed=7, n_shards=4, shard_id=shard)
    tp = TokenPipeline(vocab, 2, seq, seed=7, n_shards=4, shard_id=shard,
                       device="cpu")
    for _ in range(3):
        (jt, jl), (tt, tl) = next(jp), next(tp)
        assert tt.shape == (2, seq) and tt.dtype == torch.int64
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert torch.equal(tt[:, 1:], tl[:, :-1])


def test_gumbel_draws_equal_jax_bitwise():
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    want = np.asarray(jax.random.gumbel(key, (300, 1000))).reshape(-1)
    tkey = prng.fold_in(prng.PRNGKey(3), 5)
    got = prng.gumbel(tkey, (300, 1000)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    part = prng.gumbel(tkey, (300, 1000), start=12345, count=777).numpy()
    np.testing.assert_array_equal(part.view(np.uint32),
                                  want[12345:12345 + 777].view(np.uint32))


def test_pipeline_resumes_its_sequence():
    pipe = TokenPipeline(100, 3, 5, seed=2, device="cpu")
    first = [next(pipe) for _ in range(4)]
    saved = PipelineState.from_dict(pipe.state.to_dict())
    fifth = next(pipe)
    again = TokenPipeline(100, 3, 5, seed=2, device="cpu")
    again.restore(saved)
    assert torch.equal(next(again)[0], fifth[0])
    other = TokenPipeline(100, 3, 5, seed=2, shard_id=1, device="cpu")
    assert not torch.equal(next(other)[0], first[0][0])


def test_tree_walks_in_the_references_order_and_paths():
    """One tree module serves the optimizer and the checkpoint: its leaf
    order and key paths are jax's (dict keys sorted, NamedTuple fields by
    name, ``None`` empty), and ``tree_map``/``unflatten`` rebuild the
    structure, NamedTuples included."""
    tree = {"z": [np.float32(1), (np.float32(2), None)], "a": {
        "opt": joptim.OptState(mu={"w": np.float32(3)}, nu=[np.float32(4)],
                               step=np.int32(5))}}
    jleaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    paths, vals = leaves_with_paths(tree)
    assert paths == ["/".join(str(k) for k in p) for p, _ in jleaves]
    assert vals == [v for _, v in jleaves] == leaves(tree)
    doubled = tree_map(lambda v: v * 2, tree)
    assert list(doubled) == ["z", "a"]
    assert isinstance(doubled["a"]["opt"], joptim.OptState)
    assert leaves(doubled) == [2 * v for v in vals]
    back = unflatten(tree, [v + 1 for v in vals])
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    assert leaves(back) == [v + 1 for v in vals]
