"""The port's Mamba-2 family against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through ``repro.models`` /
``repro.kernels`` and their counterparts in ``repro_torch``; the port's
SSD scan runs its plain version (``kernels/ref.ssd_scan_ref``, the
sequential recurrence) on CPU tensors.  Weights carry across through
``convert.model_params_from_arrays``.  Tolerances:
  * ``causal_conv1d``: rtol = atol = 1e-5 (float32 shifted sums);
  * the SSD scan: rtol = atol = 2e-4 against the reference's sequential
    plain version and against its Pallas kernel in interpret mode (the
    chunked form), the reference's own chunked-vs-sequential tolerance
    (``tests/test_kernels.py``);
  * ``ssm_block`` and forward logits of reduced mamba2 (float32, 2
    layers): rtol = atol = 1e-4, against the reference run both with
    its plain scan and with its Pallas kernel.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.models import forward, init_params, layers  # noqa: E402
from repro_torch.models.config import BlockKind  # noqa: E402
from repro_torch.models.ssm import SSM, ssm_block  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# causal conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    B, S, C, W = 2, 37, 48, 4
    x, w, b = _np(0, B, S, C), _np(1, W, C, scale=0.5), _np(2, C)
    state = _np(3, B, W - 1, C) if with_state else None
    want_y, want_s = jlayers.causal_conv1d(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
        None if state is None else jnp.asarray(state))
    conv = layers.CausalConv1d(C, W, torch.float32)
    conv.w.copy_(_t(w))
    conv.b.copy_(_t(b))
    got_y, got_s = layers.causal_conv1d(
        conv, _t(x), None if state is None else _t(state))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               **LAYER_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **LAYER_TOL)


# ---------------------------------------------------------------------------
# the SSD scan: the plain version against the reference's plain version
# and its Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _ssd_case(seed, B, S, H, G, P, N, a_log=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    if a_log is None:
        a_log = rng.uniform(-2.0, 0.5, H).astype(np.float32)
    b = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    return x, np.asarray(a_log, np.float32), b, c, dt


def _both_references(args):
    j = [jnp.asarray(a) for a in args]
    return np.asarray(jref.ssd_scan_ref(*j)), np.asarray(jops.ssd_scan(*j))


@pytest.mark.parametrize("B,S,H,G,P,N", [
    (1, 128, 2, 2, 16, 16),
    (2, 256, 4, 1, 32, 16),   # grouped B/C (G < H)
    (1, 100, 2, 2, 8, 8),     # unaligned S
    (2, 100, 4, 2, 32, 16),   # grouped and unaligned
])
def test_ssd_scan_matches_reference_and_pallas(B, S, H, G, P, N):
    args = _ssd_case(S + P, B, S, H, G, P, N)
    got = ops.ssd_scan(*map(_t, args)).numpy()
    plain, pallas = _both_references(args)
    np.testing.assert_allclose(got, plain, **SCAN_TOL)
    np.testing.assert_allclose(got, pallas, **SCAN_TOL)


def test_ssd_scan_state_carry_across_chunks():
    """A single impulse at t = 0 echoes with exp decay far past the first
    chunk: the state is carried."""
    B, S, H, P, N = 1, 256, 1, 4, 4
    x = np.zeros((B, S, H, P), np.float32)
    x[0, 0] = 1.0
    a_log = np.asarray([-1.0], np.float32)
    b = np.full((B, S, H, N), 0.5, np.float32)
    c = np.full((B, S, H, N), 0.5, np.float32)
    dt = np.full((B, S, H), 0.1, np.float32)
    args = (x, a_log, b, c, dt)
    got = ops.ssd_scan(*map(_t, args)).numpy()
    plain, pallas = _both_references(args)
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-6)
    assert abs(got[0, 200, 0, 0]) > 0


def test_ssd_scan_at_mamba2_decay_rates_is_finite():
    """mamba2's own a_log = log(linspace(1, 16, H)): a 128-step chunk
    reaches decay exponents past 1,000, where exp-then-mask gives NaN."""
    H = 8
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    args = _ssd_case(5, 2, 200, H, 1, 16, 16, a_log=a_log)
    x, _, b, c, dt = args
    dt = dt * 2.0                       # steps up to ~8: exponents ~ -1e4
    args = (x, a_log, b, c, dt)
    got = ops.ssd_scan(*map(_t, args)).numpy()
    assert np.isfinite(got).all()
    plain, pallas = _both_references(args)
    np.testing.assert_allclose(got, plain, **SCAN_TOL)
    np.testing.assert_allclose(got, pallas, **SCAN_TOL)


def test_ssd_scan_bf16_matches_reference():
    args = _ssd_case(9, 1, 64, 4, 2, 16, 8)
    x, a_log, b, c, dt = args
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = jref.ssd_scan_ref(jb(x), jnp.asarray(a_log), jb(b), jb(c),
                             jnp.asarray(dt))
    tb = lambda a: _t(a).to(torch.bfloat16)
    got = ops.ssd_scan(tb(x), _t(a_log), tb(b), tb(c), _t(dt))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)


def test_ssd_scan_wrapper_checks_and_counts_no_cpu_launch():
    x, a_log, b, c, dt = map(_t, _ssd_case(1, 1, 10, 4, 2, 8, 8))
    before = kssd.ssd_scan_cuda.launches
    out = kssd.ssd_scan_cuda(x, a_log, b, c, dt)
    assert kssd.ssd_scan_cuda.launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  ref.ssd_scan_ref(x, a_log, b, c, dt))
    with pytest.raises(ValueError, match="multiple of G"):
        kssd.ssd_scan_cuda(x, a_log, b[:, :, :1].expand(1, 10, 3, 8),
                           c[:, :, :1].expand(1, 10, 3, 8), dt)
    with pytest.raises(ValueError, match="float32"):
        kssd.ssd_scan_cuda(x, a_log, b, c, dt.double())
    with pytest.raises(ValueError, match="share"):
        kssd.ssd_scan_cuda(x, a_log, b.bfloat16(), c, dt)
    with pytest.raises(ValueError, match="dt must be"):
        kssd.ssd_scan_cuda(x, a_log, b, c, dt[:, :5])


# ---------------------------------------------------------------------------
# the block and the whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    """(reference config, reference params, port model) of reduced
    mamba2-130m."""
    jcfg = jget_config("mamba2-130m", reduced=True)
    jp = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(3),
                                                 jcfg)
    cfg = get_config("mamba2-130m", reduced=True)
    return jcfg, jp, convert.model_params_from_arrays(_tree_np(jp), cfg,
                                                      device="cpu")


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_block_matches_reference(reduced, use_kernel):
    jcfg, jp, model = reduced
    p0 = jax.tree.map(lambda a: a[0], jp["segments"][0]["b0"]["ssm"])
    x = _np(11, 2, 100, jcfg.d_model)
    want, _ = jssm.ssm_block(p0, jcfg, jnp.asarray(x), use_kernel=use_kernel)
    blk = model.segments[0][0]
    got = ssm_block(blk.ssm, model.cfg, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_array_equal(blk.ssm(_t(x)).numpy(), got.numpy())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_forward_logits_match_reference(reduced, use_kernel):
    jcfg, jp, model = reduced
    tokens = _tokens(7, 2, 100, jcfg.vocab)
    want, _ = jforward(jp, jcfg, jnp.asarray(tokens), use_kernel=use_kernel,
                       remat=False)
    got, aux = forward(model, _t(tokens).long())
    assert got.shape == (2, 100, jcfg.vocab_padded) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_mamba2_130m_config_is_the_published_width():
    cfg = get_config("mamba2-130m")
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.vocab_padded,
            cfg.tie_embeddings) == (24, 768, 50280, 50688, True)
    assert (s.d_state, s.head_dim, s.expand, s.n_groups, s.d_conv) == (
        128, 64, 2, 1, 4)
    assert s.expand * cfg.d_model // s.head_dim == 24      # SSD heads
    assert cfg.pdtype == cfg.cdtype == torch.bfloat16
    assert cfg.is_attention_free()
    assert not get_config("gemma-7b").is_attention_free()
    assert cfg == get_config("mamba2_130m")
    for reduced_ in (False, True):
        mine = get_config("mamba2-130m", reduced=reduced_)
        theirs = jget_config("mamba2-130m", reduced=reduced_)
        assert mine.name == theirs.name
        assert mine.n_layers == theirs.n_layers
        assert mine.vocab_padded == theirs.vocab_padded
        assert dataclasses.asdict(mine.ssm) == dataclasses.asdict(theirs.ssm)
        assert [k.value for seg in mine.segments for k in seg.kinds] == [
            k.value for seg in theirs.segments for k in seg.kinds]
    # about 129 M parameters at the published width, counted from shapes
    d, di, H, ch = 768, 1536, 24, 1536 + 2 * 128
    per_layer = d * (2 * di + 2 * 128 + H) + 5 * ch + 3 * H + di + di * d + d
    assert abs((50688 * d + 24 * per_layer + d) / 1e6 - 129.3) < 0.1


def test_ssm_init_draws_the_reference_distributions():
    """normal / sqrt(fan_in) projections, conv w normal / sqrt(4) and b 0,
    a_log = log(linspace(1, 16, H)), dt_bias 0, d_skip 1, norm scale 1;
    a_log, dt_bias and d_skip in float32 even with bf16 parameters."""
    cfg = dataclasses.replace(get_config("mamba2-130m", reduced=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    blk = model.segments[0][1]
    assert type(blk).__name__ == "SSMBlock" and not hasattr(blk, "mlp")
    ssm = blk.ssm
    assert isinstance(ssm, SSM)
    H = ssm.a_log.shape[0]
    for t in (ssm.a_log, ssm.dt_bias, ssm.d_skip):
        assert t.dtype == torch.float32
    assert ssm.w_in.dtype == ssm.conv.w.dtype == torch.bfloat16
    torch.testing.assert_close(ssm.a_log,
                               torch.log(torch.linspace(1.0, 16.0, H)))
    assert torch.all(ssm.dt_bias == 0) and torch.all(ssm.d_skip == 1)
    assert torch.all(ssm.norm_scale == 1) and torch.all(ssm.conv.b == 0)
    for w, fan_in in ((ssm.w_in, cfg.d_model), (ssm.conv.w, 4),
                      (ssm.w_out, ssm.w_out.shape[0])):
        assert abs(float(w.float().std()) * fan_in ** 0.5 - 1.0) < 0.15
    out, _ = forward(model, torch.zeros((1, 8), dtype=torch.long))
    assert torch.isfinite(out[..., :cfg.vocab]).all()


def test_mixed_ssm_and_attention_units_keep_the_layer_order():
    """A segment whose unit mixes kinds puts copy r of block j at layer
    r * len(kinds) + j, as convert.py reads the reference's stacks."""
    base = get_config("mamba2-130m", reduced=True)
    seg = dataclasses.replace(base.segments[0],
                              kinds=(BlockKind.SSM, BlockKind.ATTN),
                              repeat=2)
    cfg = dataclasses.replace(base, segments=(seg,), d_ff=64)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    kinds = [type(b).__name__ for b in model.segments[0]]
    assert kinds == ["SSMBlock", "Block", "SSMBlock", "Block"]
