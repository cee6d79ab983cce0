"""The port's cells and step builders (``repro_torch.launch.steps``) and
its roofline (``launch/hlo_analysis.py``) against the reference's
``repro.launch.steps`` and ``repro.launch.hlo_analysis``, on the CPU.

``SHAPES``, ``TRAIN_MICROBATCHES``, ``shape_applicable``, ``input_specs``
and the meta parameter tree, cache and optimizer state are the
reference's (its ``jax.eval_shape`` trees leaf for leaf, by path, shape
and dtype) at every one of the 10 archs x 4 shapes; ``active_params`` and
``model_flops`` are equal exactly; ``roofline`` is the reference's record
with the reference's peaks set to the H100's.  The built train, prefill
and decode steps of reduced float32 gemma-7b, mamba2-130m and
granite-moe-1b-a400m (the reference's weights carried across by
``convert.py``) agree with the reference's builders on a (1, 1) mesh
with ``REPRO_LAYOUT=tp`` (which keeps the microbatches) within 1e-4, at a
small shape of each kind added to both ``SHAPES``; the built train step
at one microbatch is ``launch/train.make_step``'s, bitwise.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.compat import make_mesh as jmake_mesh  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.launch import hlo_analysis as jha  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import pspec as jpspec  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
from repro_torch.launch import mesh, steps, train  # noqa: E402
from repro_torch.models import init_cache, param_tree  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

ARCHS = list_archs()
TOL = dict(rtol=1e-4, atol=1e-4)
# reduced float32 configs of the dense, SSM and MoE families
BUILT_ARCHS = ["gemma-7b", "mamba2-130m", "granite-moe-1b-a400m"]
# one small shape of each kind, added to both SHAPES at test time
TINY = {"train_tiny": dict(seq=32, batch=4, kind="train"),
        "prefill_tiny": dict(seq=24, batch=2, kind="prefill"),
        "decode_tiny": dict(seq=40, batch=2, kind="decode")}
DECODE_POS = 29


def test_archs_are_the_references():
    assert ARCHS == jlist_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_skip_rule_are_the_references(arch):
    assert steps.SHAPES == jsteps.SHAPES
    assert steps.TRAIN_MICROBATCHES == jsteps.TRAIN_MICROBATCHES
    for shape in jsteps.SHAPES:
        assert (steps.shape_applicable(get_config(arch), shape)
                == jsteps.shape_applicable(jget_config(arch), shape))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _specs(tree):
    """{path in jax's keystr form: (shape, dtype)} of a port tree."""
    paths, vals = leaves_with_paths(tree)
    return {p.replace("/", ""): (tuple(v.shape), _dtype(v))
            for p, v in zip(paths, vals)}


def _jspecs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(v.shape), v.dtype.name)
            for p, v in flat}


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jsteps.abstract_params(jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_the_references(arch):
    for shape in jsteps.SHAPES:
        got = steps.input_specs(get_config(arch), shape)
        want = jsteps.input_specs(jget_config(arch), shape)
        assert list(got) == list(want)
        for k in want:
            assert got[k].is_meta
            assert tuple(got[k].shape) == tuple(want[k].shape), (shape, k)
            assert _dtype(got[k]) == want[k].dtype.name, (shape, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_are_the_references(arch):
    """The parameters, the AdamW state and, at every serving cell, the
    cache: leaf for leaf the reference's ``jax.eval_shape`` trees."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    params = steps.abstract_params(cfg)
    assert all(t.is_meta for t in leaves(params))
    assert _specs(params) == _jspecs(_jparams(arch))
    assert (_specs(steps.abstract_opt_state(params))
            == _jspecs(jsteps.abstract_opt_state(_jparams(arch))))
    for shape, s in jsteps.SHAPES.items():
        if s["kind"] == "train" or not jsteps.shape_applicable(
                jcfg, shape)[0]:
            continue
        B, S = s["batch"], s["seq"]
        smax = S + (cfg.frontend_tokens if s["kind"] == "prefill"
                    and cfg.frontend == "vision" else 0)
        assert (_specs(steps.abstract_cache(cfg, B, smax))
                == _jspecs(jsteps.abstract_cache(jcfg, B, smax))), shape


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_are_the_references(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert ha.active_params(cfg) == jha.active_params(jcfg)
    for shape, s in jsteps.SHAPES.items():
        n = s["batch"] * (s["seq"] if s["kind"] != "decode" else 1)
        assert ha.model_flops(cfg, shape, n) == jha.model_flops(jcfg, shape,
                                                                 n)


@pytest.mark.parametrize("n_devices", [1, 4])
def test_roofline_is_the_references_at_the_h100s_peaks(monkeypatch,
                                                       n_devices):
    monkeypatch.setattr(jha, "PEAK_FLOPS", ha.PEAK_FLOPS)
    monkeypatch.setattr(jha, "HBM_BW", ha.HBM_BW)
    for flops in (0.0, 1e9, 3.7e15):
        for nbytes in (0.0, 2e9, 5.1e13):
            for mf in (0.0, 1e12, 2.2e15):
                got = ha.roofline(flops, nbytes, 0, mf, n_devices).to_dict()
                want = jha.roofline(flops, nbytes, 0, mf,
                                    n_devices).to_dict()
                assert got == want, (flops, nbytes, mf)
    with pytest.raises(ValueError, match="interconnect"):
        ha.roofline(1e9, 1e9, 1.0, 1e9, 1)


def test_production_mesh_is_the_references_at_one_card():
    m = mesh.make_production_mesh()
    jm = jmake_mesh((1, 1), ("data", "model"))
    assert m.axis_names == jm.axis_names and m.size == jm.devices.size
    for fn in ("data_axes", "tp_size", "dp_size"):
        assert getattr(mesh, fn)(m) == getattr(jmesh, fn)(jm)
    with pytest.raises(ValueError, match="one card"):
        mesh.make_production_mesh(multi_pod=True)


# ---------------------------------------------------------------------------
# The built steps against the reference's, reduced float32 configs
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny(monkeypatch):
    """The small shapes in both SHAPES; the reference's builder on a (1, 1)
    mesh with the TP layout (its "auto" would take FSDP and one
    microbatch), its sharding axes cleared after."""
    for name, s in TINY.items():
        monkeypatch.setitem(jsteps.SHAPES, name, s)
        monkeypatch.setitem(steps.SHAPES, name, s)
    monkeypatch.setenv("REPRO_LAYOUT", "tp")
    yield jmake_mesh((1, 1), ("data", "model"))
    jpspec.clear()


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = jget_config(arch, reduced=True)
    return jcfg, jax.tree.map(np.asarray, jinit_params(
        jax.random.PRNGKey(0), jcfg))


def _carry(arch):
    """The reference's reduced weights, as both packages' parameters."""
    jcfg, arrays = _weights(arch)
    cfg = get_config(arch, reduced=True)
    assert cfg.pdtype == torch.float32
    model = convert.model_params_from_arrays(arrays, cfg, device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, arrays), cfg, model


def _tokens(cfg, seed, *shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL,
                               err_msg=what)


def _close_trees(got, want, what):
    paths, g = leaves_with_paths(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for p, a, b in zip(paths, g, w):
        _close(a.detach().numpy(), b, f"{what} {p}")


@pytest.mark.parametrize("arch", BUILT_ARCHS)
def test_built_train_step_matches_the_references(tiny, arch):
    jcfg, jp, cfg, model = _carry(arch)
    tokens, labels = _tokens(cfg, 1, 4, 32), _tokens(cfg, 2, 4, 32)
    jb = jsteps.build_train_step(jcfg, tiny, "train_tiny", microbatches=2)
    with tiny:
        jparams, jopt, jloss, _ = jb.fn(jp, joptim.init(jp),
                                        jnp.asarray(tokens),
                                        jnp.asarray(labels))
    built = steps.build_train_step(cfg, mesh.make_production_mesh(),
                                   "train_tiny", microbatches=2)
    assert [tuple(t.shape) for t in built.args[3:]] == [(4, 32), (4, 32)]
    params = param_tree(model)
    p, o, loss, metrics = built.fn(model, params, optim.init(params),
                                   torch.from_numpy(tokens),
                                   torch.from_numpy(labels))
    _close(float(loss), float(jloss), "loss")
    _close_trees(p, jparams, "params")
    _close_trees(o.mu, jopt.mu, "mu")
    _close_trees(o.nu, jopt.nu, "nu")
    assert int(o.step) == int(jopt.step) == 1


@pytest.mark.parametrize("arch", BUILT_ARCHS)
def test_built_prefill_step_matches_the_references(tiny, arch):
    jcfg, jp, cfg, model = _carry(arch)
    tokens = _tokens(cfg, 3, 2, 24)
    jb = jsteps.build_prefill_step(jcfg, tiny, "prefill_tiny")
    with tiny:
        jlogits, jcache = jb.fn(jp, jinit_cache(jcfg, 2, 24),
                                jnp.asarray(tokens))
    built = steps.build_prefill_step(cfg, mesh.make_production_mesh(),
                                     "prefill_tiny")
    cache = init_cache(cfg, 2, 24, device="cpu")
    logits, cache = built.fn(model, cache, torch.from_numpy(tokens))
    _close(logits.numpy(), jlogits, "logits")
    _close_trees(cache, jcache, "cache")


@pytest.mark.parametrize("arch", BUILT_ARCHS)
def test_built_decode_step_matches_the_references(tiny, arch):
    """One token at position DECODE_POS against a cache of 40 positions
    filled with draws (every row below the position attended)."""
    jcfg, jp, cfg, model = _carry(arch)
    rng = np.random.default_rng(4)
    filled = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(np.float32),
        jax.tree.map(np.asarray, jinit_cache(jcfg, 2, 40)))
    token = _tokens(cfg, 5, 2, 1)
    jb = jsteps.build_decode_step(jcfg, tiny, "decode_tiny")
    with tiny:
        jlogits, jcache = jb.fn(jp, jax.tree.map(jnp.asarray, filled),
                                jnp.asarray(token), jnp.int32(DECODE_POS))
    built = steps.build_decode_step(cfg, mesh.make_production_mesh(),
                                    "decode_tiny")
    logits, cache = built.fn(
        model, convert.cache_from_arrays(filled, cfg, device="cpu"),
        torch.from_numpy(token), torch.tensor(DECODE_POS,
                                              dtype=torch.int32))
    _close(logits.numpy(), jlogits, "logits")
    _close_trees(cache, jcache, "cache")


@pytest.mark.parametrize("arch", ["gemma-7b", "mamba2-130m"])
def test_built_train_step_at_one_microbatch_is_make_step(tiny, arch):
    """The built step (its float32 accumulation over one microbatch) and
    ``launch/train.make_step``: loss, parameters and moments bitwise."""
    _, _, cfg, model = _carry(arch)
    tokens = torch.from_numpy(_tokens(cfg, 6, 4, 32))
    labels = torch.from_numpy(_tokens(cfg, 7, 4, 32))
    opt_cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=1)
    params = param_tree(model)
    state = (params, optim.init(params))
    built = steps.build_train_step(cfg, mesh.make_production_mesh(),
                                   "train_tiny", microbatches=1,
                                   opt_cfg=opt_cfg)
    with train.deterministic():
        (p1, o1), l1 = train.make_step(model, opt_cfg)(state,
                                                       (tokens, labels))
        p2, o2, l2, _ = built.fn(model, *state, tokens, labels)
    got, want = leaves((p2, o2, l2)), leaves((p1, o1, l1))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(leaves(p1)[0], leaves(params)[0])


def test_train_builder_cuts_depth_and_checks_microbatches(tiny):
    cfg = get_config("deepseek-v2-lite-16b")
    built = steps.build_train_step(cfg, mesh.make_production_mesh(),
                                   "train_4k", layers=3)
    assert built.args[0].cfg.n_layers == 3
    assert tuple(built.args[3].shape) == (256, 4096)
    with pytest.raises(ValueError, match="microbatches"):
        steps.build_train_step(get_config("mamba2-130m"),
                               mesh.make_production_mesh(), "train_4k",
                               microbatches=3)
    with pytest.raises(ValueError, match="one card"):
        steps.build_step(cfg, mesh.Mesh({"data": 2, "model": 1}),
                         "decode_32k")
