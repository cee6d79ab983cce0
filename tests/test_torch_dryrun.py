"""The dry run's tooling on the CPU (no jax): the cost counter
(``launch/op_cost.py``), the kernel wrappers' meta routes, the kernels'
cost functions (``launch/hlo_analysis.py``) and ``launch/dryrun.py`` over
every (arch, shape) cell at the published widths.

* The trip-aware count of a loop (``op_cost.trips``) equals the unrolled
  loop's exactly -- FLOPs, bytes and peak -- for ``ssm._ssd_recurrent`` in
  a reduced mamba2's stateful prefill.
* Each wrapper's meta route calls its ``plan`` at the call's shapes,
  launches nothing, reports its cost and returns its CPU route's shapes
  and dtypes; it raises where ``plan`` (or the wrapper's checks) refuse.
* The live-bytes tracker's peak on a chain of ops counted by hand; a
  cell's parameters, moments and cache equal their analytic sums.
* The cost functions give PERF.md section 6's figures at their shapes.
* ``run_cell`` finishes every cell with ``ok`` and no loop of unknown
  trip count, and every kernel launch through its plan.
"""
import json

import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import dryrun, op_cost, steps
from repro_torch.launch import hlo_analysis as ha
from repro_torch.models import attention, count_params, init_cache, ssm
from test_torch_cuda import one_torch_thread  # noqa: F401

META = "meta"


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# cost functions: PERF.md section 6's figures (NVIDIA H100 80GB HBM3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn, args, kw, gflop, mb, bound_ms", [
    # the retrieval path: 64 documents of 128 tokens, gemma-7b's heads
    (ha.flash_fwd_cost, (64, 16, 16, 128, 128, 256, 256),
     dict(causal=True), None, 268.4, 0.0801),
    # the decode path's prefill (8, 16, 2,048, 256)
    (ha.flash_fwd_cost, (8, 16, 16, 2048, 2048, 256, 256),
     dict(causal=True), 275.01, None, 0.2781),
    # deepseek's prefill: q/k 192, v 128
    (ha.flash_fwd_cost, (8, 16, 16, 2048, 2048, 192, 128),
     dict(causal=True), 171.88, None, 0.1738),
    # whisper's cross-attention at a decode step (Sq = 1), non-causal
    (ha.flash_fwd_cost, (8, 16, 16, 1, 1500, 64, 64),
     dict(causal=False), None, 49.2, 0.0147),
    # the train_dense path's gradient (2 x 1,024)
    (ha.flash_bwd_cost, (2, 16, 16, 1024, 1024, 256, 256),
     dict(causal=True), 42.99, 134.3, 0.0435),
    # the SSD scan at the mamba2 retrieval path (64 x 1,024)
    (ha.ssd_fwd_cost, (64, 1024, 24, 64, 1, 128), {}, None, 442.5, 0.1321),
    # the SSD gradient at the train path (8 x 1,024)
    (ha.ssd_bwd_cost, (8, 1024, 24, 64, 1, 128), {}, 22.65, 85.5, 0.0255),
])
def test_cost_functions_give_the_recorded_figures(fn, args, kw, gflop, mb,
                                                  bound_ms):
    flops, nbytes = fn(*args, itemsize=2, **kw)
    if gflop is not None:
        assert round(flops / 1e9, 2) == gflop
    if mb is not None:
        assert round(nbytes / 1e6, 1) == mb
    bound, _ = ha.bound_of(flops, ha.PEAK_FLOPS, nbytes)
    assert round(bound, 4) == bound_ms


def test_flash_cost_counts_the_lse_it_writes():
    without = ha.flash_fwd_cost(2, 4, 2, 64, 64, 32, 32, causal=True,
                                itemsize=2)
    with_lse = ha.flash_fwd_cost(2, 4, 2, 64, 64, 32, 32, causal=True,
                                 itemsize=2, lse=True)
    assert with_lse == (without[0], without[1] + 4 * 2 * 4 * 64)


# ---------------------------------------------------------------------------
# the live-bytes tracker, FLOPs and bytes on hand-counted ops
# ---------------------------------------------------------------------------

def test_live_bytes_peak_on_a_hand_counted_chain():
    with op_cost.Counter() as c:
        x = _meta(1000, dtype=torch.float32)      # 4,000 -> a 4,096 block
        assert c.live == 4096
        y = x * 2.0                                # + 4,096
        v = y.view(10, 100)                        # a view: nothing
        v.add_(1.0)                                # in place: nothing
        assert c.live == 8192
        del x                                      # - 4,096
        assert c.live == 4096
        z = torch.cat([y, y])                      # + 8,192 (8,000)
        w = z[:1000] + y                           # + 4,096: 16,384 live
        del v, y, z                                # w is its own storage
        assert c.live == 4096 and c.peak == 16384
        s = _meta(3, dtype=torch.int8)             # 3 bytes: one block
        assert c.live == 4096 + 512
        m = _meta(64, 32, dtype=torch.float32) @ _meta(32, 16,
                                                       dtype=torch.float32)
        # both operands (8,192 + 2,048) and the product (4,096) beside w, s
        assert c.peak == 4096 + 512 + 8192 + 2048 + 4096
        assert c.live == 4096 + 512 + 4096
        del w, s, m
    assert c.flops == 2 * 64 * 32 * 16
    # bytes: mul reads 4,000, writes 4,000; add_ 4,000 both ways; cat reads
    # 2 x 4,000, writes 8,000; add reads 4,000 twice, writes 4,000; the
    # product reads 8,192 + 2,048 and writes 4,096
    assert c.bytes == 8000 + 8000 + 16000 + 12000 + 14336


def test_hold_counts_what_was_made_before():
    x, y = _meta(2048, dtype=torch.float32), _meta(100, dtype=torch.float32)
    with op_cost.Counter() as c:
        assert c.hold([x, {"a": y, "b": x[:10]}]) == 8192 + 512
        x2 = x + 1
        assert c.peak == 8192 + 512 + 8192
        del x2
    assert c.live == 8192 + 512


def test_bincount_has_a_meta_kernel_in_the_counter():
    ids = torch.empty((96,), dtype=torch.int64, device=META)
    with op_cost.Counter():
        out = torch.bincount(ids, minlength=8)
        assert out.shape == (8,) and out.dtype == torch.int64
        with pytest.raises(NotImplementedError, match="minlength"):
            torch.bincount(ids)


def test_trip_aware_recurrence_equals_the_unrolled_loop():
    """A reduced mamba2's stateful prefill (one Python step a token in
    ``_ssd_recurrent``): its one step counted S times against all S."""
    cfg = get_config("mamba2-130m", reduced=True)
    counts = []
    for aware in (True, False):
        model = steps.abstract_model(cfg)
        cache = init_cache(cfg, 3, 37, device=META)
        tokens = torch.empty((3, 37), dtype=torch.int32, device=META)
        with op_cost.Counter(trip_aware=aware) as c:
            c.hold([list(model.parameters()), cache, tokens])
            out = steps.prefill(model, tokens, cache)
            del out
        counts.append((c.flops, c.bytes, c.peak, c.live,
                       c.unknown_trip_loops))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][4] == 0


def test_trip_aware_recurrence_alone_and_its_outputs():
    """``_ssd_recurrent`` alone at S = 19: counts equal, and the output is
    shaped for all S steps."""
    cfg = get_config("mamba2-130m", reduced=True)
    p = ssm.SSM(cfg, META)
    H, P, N = 8, cfg.ssm.head_dim, cfg.ssm.d_state
    res = []
    for aware in (True, False):
        xh, bh, ch = _meta(2, 19, H, P), _meta(2, 19, 1, N), _meta(2, 19, 1, N)
        dt = _meta(2, 19, H, dtype=torch.float32)
        state = _meta(2, H, P, N, dtype=torch.float32)
        with op_cost.Counter(trip_aware=aware) as c:
            c.hold([xh, bh, ch, dt, state, list(p.parameters())])
            y, new = ssm._ssd_recurrent(p, xh, bh, ch, dt, state, 1, H)
            assert y.shape == xh.shape and new.shape == state.shape
            del y, new
        res.append((c.flops, c.bytes, c.peak))
    assert res[0] == res[1]


def test_unknown_trip_count_is_counted_once_and_tallied():
    x = _meta(4, dtype=torch.float32)
    with op_cost.Counter() as c:
        with op_cost.trips(None, x) as n:
            assert n == 1
            y = x + 1
        del y
    assert c.unknown_trip_loops == 1
    with op_cost.trips(5, x) as n:          # no counter: every iteration
        assert n == 5


# ---------------------------------------------------------------------------
# the kernel wrappers' meta routes
# ---------------------------------------------------------------------------

def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(module, name, spy)
    return calls


def _like(t):
    return torch.randn(t.shape, dtype=torch.float32).to(t.dtype)


@pytest.mark.parametrize("dv, lse", [(32, False), (32, True), (16, True)])
def test_flash_meta_route_is_the_cards(monkeypatch, dv, lse):
    q, k, v = _meta(2, 4, 24, 32), _meta(2, 2, 24, 32), _meta(2, 2, 24, dv)
    plans = _spy(monkeypatch, kfa, "plan")
    before = kfa.flash_attention_cuda.launches
    with op_cost.Counter() as c:
        got = kfa.flash_attention_cuda(q, k, v, return_lse=lse)
    assert kfa.flash_attention_cuda.launches == before and len(plans) == 1
    rec = c.kernels["flash_attention"]
    assert rec["launches"] == 1 and rec["designs"] == {"tensor_core": 1}
    assert rec["flops"] == ha.flash_fwd_cost(2, 4, 2, 24, 24, 32, dv,
                                             causal=True, itemsize=2)[0]
    want = kfa.flash_attention_cuda(_like(q), _like(k), _like(v),
                                    return_lse=lse)
    for g, w in zip(*((got, want) if lse else ((got,), (want,)))):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype


def test_flash_bwd_meta_route_is_the_cards(monkeypatch):
    q, k, v = _meta(2, 4, 24, 32), _meta(2, 2, 24, 32), _meta(2, 2, 24, 16)
    o, lse = _meta(2, 4, 24, 16), _meta(2, 4, 24, dtype=torch.float32)
    plans = _spy(monkeypatch, kfa, "bwd_plan")
    before = kfa.flash_attention_bwd_cuda.launches
    with op_cost.Counter() as c:
        got = kfa.flash_attention_bwd_cuda(q, k, v, o, lse, o)
    assert kfa.flash_attention_bwd_cuda.launches == before
    assert len(plans) == 1
    assert c.kernels["flash_attention_bwd"]["designs"] == {"tensor_core": 1}
    cpu = [_like(t) for t in (q, k, v, o)]
    want = kfa.flash_attention_bwd_cuda(*cpu, torch.zeros(lse.shape), cpu[3])
    for g, w in zip(got, want):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype


def test_ssd_meta_routes_are_the_cards(monkeypatch):
    x, b = _meta(2, 40, 4, 16), _meta(2, 40, 2, 16)
    dt, a_log = _meta(2, 40, 4, dtype=torch.float32), _meta(
        4, dtype=torch.float32)
    plans = _spy(monkeypatch, kssd, "plan")
    bwd_plans = _spy(monkeypatch, kssd, "bwd_plan")
    launches = (kssd.ssd_scan_cuda.launches, kssd.ssd_scan_bwd_cuda.launches)
    with op_cost.Counter() as c:
        y = kssd.ssd_scan_cuda(x, a_log, b, b, dt)
        grads = kssd.ssd_scan_bwd_cuda(x, a_log, b, b, dt, y)
    assert (kssd.ssd_scan_cuda.launches,
            kssd.ssd_scan_bwd_cuda.launches) == launches
    assert len(plans) == len(bwd_plans) == 1
    assert {k: v["designs"] for k, v in c.kernels.items()} == {
        "ssd_scan": {"tensor_core": 1}, "ssd_scan_bwd": {"tensor_core": 1}}
    assert c.kernels["ssd_scan_bwd"]["bytes"] == ha.ssd_bwd_cost(
        2, 40, 4, 16, 2, 16, itemsize=2)[1]
    cx, cb, cdt = _like(x), _like(b), torch.rand(dt.shape)
    want_y = kssd.ssd_scan_cuda(cx, torch.zeros(4), cb, cb, cdt)
    want = kssd.ssd_scan_bwd_cuda(cx, torch.zeros(4), cb, cb, cdt, want_y)
    for g, w in zip((y, *grads), (want_y, *want)):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype


def test_meta_routes_raise_where_the_card_would():
    with pytest.raises(ValueError, match="causal"):
        kfa.flash_attention_cuda(_meta(1, 2, 8, 32), _meta(1, 2, 16, 32),
                                 _meta(1, 2, 16, 32))
    with pytest.raises(ValueError, match="head width"):
        kfa.flash_attention_cuda(*(_meta(1, 2, 8, 260) for _ in range(3)))
    with pytest.raises(ValueError, match="head width"):
        kssd.ssd_scan_cuda(_meta(1, 8, 2, 130), _meta(2, dtype=torch.float32),
                           _meta(1, 8, 1, 16), _meta(1, 8, 1, 16),
                           _meta(1, 8, 2, dtype=torch.float32))


def test_f32_product_takes_the_cards_route_on_meta():
    """bf16 operands, a float32-output product: no float32 copy."""
    a, b = _meta(6, 5, 32), _meta(6, 32, 7)
    with op_cost.Counter() as c:
        out = attention._f32_product(a, b)
    assert out.dtype == torch.float32 and out.shape == (6, 5, 7)
    assert c.flops == 2 * 6 * 5 * 32 * 7
    # one product: its operands read, its float32 output written
    assert c.bytes == 2 * (6 * 5 * 32 + 6 * 32 * 7) + 4 * 6 * 5 * 7


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_a_cells_parts_are_their_analytic_sums(tmp_path):
    cfg = get_config("gemma-7b")
    n = count_params(cfg)
    train = dryrun.run_cell("gemma-7b", "train_4k", str(tmp_path))
    m = train["memory"]
    assert m["params_bytes"] == 2 * n                  # bf16
    assert m["opt_state_bytes"] == 2 * 4 * n + 4       # mu, nu; the step
    assert m["inputs_bytes"] == 2 * 256 * 4096 * 4     # int32 tokens, labels
    assert m["held_bytes"] >= 2 * m["params_bytes"] + m["opt_state_bytes"]
    assert m["peak_bytes"] == m["held_bytes"] + m["step_peak_bytes"]
    assert train["kernels"]["flash_attention"]["launches"] == 2 * 28 * 8
    assert train["kernels"]["flash_attention_bwd"]["launches"] == 28 * 8
    dec = dryrun.run_cell("gemma-7b", "decode_32k", str(tmp_path))
    # K and V of 28 blocks: (128, 16, 32,768, 256) bf16 each
    assert dec["memory"]["cache_bytes"] == 28 * 2 * 128 * 16 * 32768 * 256 * 2
    assert dec["kernels"] == {}
    assert dec["memory"]["fits"] is False


def test_every_cell_runs_on_meta(tmp_path):
    """The whole table at the published widths (~40 s on this CPU)."""
    recs = [dryrun.run_cell(a, s, str(tmp_path), force=True)
            for a in list_archs() for s in steps.SHAPES]
    assert len(list(tmp_path.glob("*.json"))) == 40
    bad = [(r["cell"], r.get("error")) for r in recs if not r["ok"]]
    assert not bad
    skipped = [r["cell"] for r in recs if r.get("skipped")]
    assert len(skipped) == 8 and all("long_500k" in c for c in skipped)
    for r in recs:
        if r.get("skipped"):
            continue
        assert r["cost"]["unknown_trip_loops"] == 0, r["cell"]
        assert all(k["plan_ok"] for k in r["kernels"].values())
        assert r["roofline"]["coll_bytes"] == 0
        assert r["memory"]["fits"] == (r["memory"]["peak_bytes"]
                                       <= ha.USABLE_BYTES)
    fits = sorted(r["cell"] for r in recs
                  if not r.get("skipped") and r["memory"]["fits"])
    assert "mamba2-130m__decode_32k" in fits
    assert "gemma-7b__train_4k" not in fits


def test_cli_writes_a_cell_and_fails_a_failed_one(tmp_path, monkeypatch,
                                                  capsys):
    dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2-130m__long_500k.json").read_text())
    assert rec["ok"] and rec["kind"] == "decode" and rec["batch"] == 1

    def broken(*a, **kw):
        raise RuntimeError("refused")
    monkeypatch.setattr(steps, "build_step", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gemma-7b", "--shape", "decode_32k", "--out",
                     str(tmp_path), "--batch", "1"])
    assert e.value.code == 1
    assert "FAIL refused" in capsys.readouterr().out
