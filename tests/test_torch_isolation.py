"""The port stands alone: no jax, no reference package, no silent CPU.

Importing every module of ``repro_torch`` (in a fresh interpreter) must
leave ``jax``, ``repro`` and ``ml_dtypes`` out of ``sys.modules``, and no
line of the port, of its examples or of ``chip_smoke.py`` may import them.  Every entry point -- the
index, the model, the retrieval service, the serve CLI, the simulator,
the oracle, the datasets, the contract gate, the serving example --
built without a ``device`` on a machine with no card raises instead of
running on the CPU.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import DistributedLSHIndex, LSHConfig
from test_torch_cuda import one_torch_thread  # noqa: F401

_REPO = pathlib.Path(__file__).resolve().parents[1]
_PORT = _REPO / "src" / "repro_torch"


def _modules():
    for path in sorted(_PORT.rglob("*.py")):
        rel = path.relative_to(_REPO / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_modules())
    for m in ("repro_torch.core.index", "repro_torch.models.transformer",
              "repro_torch.serving.retrieval", "repro_torch.launch.serve",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.ssd_scan", "repro_torch.kernels.lsh_hash",
              "repro_torch.models.ssm", "repro_torch.configs.mamba2_130m",
              "repro_torch.persist.snapshot", "repro_torch.persist.wal",
              "repro_torch.checkpoint.checkpoint",
              "repro_torch.serving.pipeline", "repro_torch.serving.workers",
              "repro_torch.core.simulate", "repro_torch.core.multiprobe",
              "repro_torch.core.ref_search", "repro_torch.core.accounting",
              "repro_torch.data.datasets", "repro_torch.data.dedup",
              "repro_torch.data.pipeline", "repro_torch.optim.adamw",
              "repro_torch.optim.compression", "repro_torch.runtime.loop",
              "repro_torch.launch.train", "repro_torch.tree",
              "repro_torch.launch.steps", "repro_torch.launch.dryrun",
              "repro_torch.launch.op_cost", "repro_torch.launch.hlo_analysis",
              "repro_torch.launch.mesh", "repro_torch.analysis",
              "repro_torch.analysis.manifest",
              "repro_torch.analysis.repolint",
              "repro_torch.analysis.trace_pass",
              "repro_torch.analysis.device_pass",
              "repro_torch.analysis.check", "repro_torch.kernels.watch"):
        assert m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.') or m.split('.')[0] == 'ml_dtypes']\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(_REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(_REPO)) for p in _PORT.rglob("*.py")]
    + [str(p.relative_to(_REPO))
       for p in (_REPO / "examples").glob("*_torch.py")]
    + ["chip_smoke.py"]))
def test_no_source_line_imports_jax_or_the_reference(path):
    tree = ast.parse((_REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "ml_dtypes"), (
                path, name)


def test_index_without_device_needs_a_card():
    cfg = LSHConfig(d=8, k=4, W=1.0, r=0.3, c=2.0, L=2, n_shards=2)
    if torch.cuda.is_available():
        assert DistributedLSHIndex(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DistributedLSHIndex(cfg)
    assert DistributedLSHIndex(cfg, device="cpu").device.type == "cpu"


def _needs_a_card(make, on_cpu):
    """make() must run on cuda when there is a card and raise without
    one; on_cpu() must run on the CPU."""
    if torch.cuda.is_available():
        make()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    on_cpu()


def test_model_without_device_needs_a_card():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("gemma-7b", reduced=True)
    gen = lambda: torch.Generator().manual_seed(0)
    _needs_a_card(lambda: init_params(cfg, generator=gen()),
                  lambda: init_params(cfg, generator=gen(), device="cpu"))


def test_cache_and_ssm_state_without_device_need_a_card():
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache
    from repro_torch.models.ssm import init_ssm_state
    for arch in ("gemma-7b", "mamba2-130m"):
        cfg = get_config(arch, reduced=True)
        _needs_a_card(lambda: init_cache(cfg, 2, 8),
                      lambda: init_cache(cfg, 2, 8, device="cpu"))
    _needs_a_card(lambda: init_ssm_state(cfg, 2),
                  lambda: init_ssm_state(cfg, 2, device="cpu"))


def test_retrieval_service_without_device_needs_a_card():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import RetrievalService
    cfg = get_config("gemma-7b", reduced=True)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    docs = torch.randint(0, cfg.vocab, (16, 8),
                         generator=torch.Generator().manual_seed(1))
    _needs_a_card(
        lambda: RetrievalService.build(cfg, model, docs),
        lambda: RetrievalService.build(cfg, model, docs, device="cpu"))


def test_serve_cli_without_device_needs_a_card():
    from repro_torch.launch import serve
    args = ["--docs", "16", "--batches", "1", "--batch-size", "8"]
    _needs_a_card(lambda: serve.main(args),
                  lambda: serve.main(args + ["--device", "cpu"]))


def test_mamba2_model_and_serve_cli_without_device_need_a_card():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    cfg = get_config("mamba2-130m", reduced=True)
    gen = lambda: torch.Generator().manual_seed(0)
    _needs_a_card(lambda: init_params(cfg, generator=gen()),
                  lambda: init_params(cfg, generator=gen(), device="cpu"))
    args = ["--arch", "mamba2-130m", "--docs", "16", "--batches", "1",
            "--batch-size", "8"]
    _needs_a_card(lambda: serve.main(args),
                  lambda: serve.main(args + ["--device", "cpu"]))


def test_train_cli_and_token_pipeline_without_device_need_a_card():
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train
    args = ["--reduced", "--steps", "12", "--batch", "2", "--seq", "16",
            "--lr", "1e-2"]
    _needs_a_card(lambda: train.main(args),
                  lambda: train.main(args + ["--device", "cpu"]))
    _needs_a_card(lambda: TokenPipeline(16, 1, 4),
                  lambda: TokenPipeline(16, 1, 4, device="cpu"))


def test_kernel_wrappers_take_their_plain_version_only_on_the_cpu():
    """On a CPU tensor the wrappers run the plain version and count no
    launch."""
    from repro_torch.kernels import bucket_search as kbs
    from repro_torch.kernels.types import QueryBatch, StoreView
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 8), generator=g)
    p = torch.randn((1, 16, 8), generator=g)
    query = QueryBatch.build(q, torch.zeros((1, 4, 2), dtype=torch.int32),
                             torch.ones((1, 4, 1), dtype=torch.int32))
    store = StoreView.build(p, torch.zeros((1, 16, 2), dtype=torch.int32),
                            torch.arange(16, dtype=torch.int32)[None],
                            torch.ones((1, 16), dtype=torch.int32))
    before = kbs.bucket_search_cuda.launches
    td, tg, cnt = kbs.bucket_search_cuda(query=query, store=store,
                                         cr2=1e9, L=1, K=3)
    assert kbs.bucket_search_cuda.launches == before
    assert torch.all(cnt == 16) and tg.shape == (1, 4, 3)

    from repro_torch.kernels import flash_attention as kfa
    q = torch.randn((1, 4, 5, 16), generator=g)
    kv = torch.randn((1, 2, 5, 16), generator=g)
    before = kfa.flash_attention_cuda.launches
    out = kfa.flash_attention_cuda(q, kv, kv, causal=True)
    assert kfa.flash_attention_cuda.launches == before
    assert out.shape == q.shape and out.dtype == q.dtype

    from repro_torch.kernels import lsh_hash as klh
    from repro_torch.kernels import ssd_scan as kssd
    x = torch.randn((2, 7, 4, 8), generator=g)
    bc = torch.randn((2, 7, 2, 16), generator=g)
    dt = torch.rand((2, 7, 4), generator=g)
    before = kssd.ssd_scan_cuda.launches
    y = kssd.ssd_scan_cuda(x, torch.zeros(4), bc, bc, dt)
    assert kssd.ssd_scan_cuda.launches == before
    assert y.shape == x.shape and y.dtype == x.dtype
    before = klh.lsh_hash_cuda.launches
    h = klh.lsh_hash_cuda(q[0, 0], torch.randn((16, 5), generator=g),
                          torch.zeros(5), w=1.0)
    assert klh.lsh_hash_cuda.launches == before
    assert h.shape == (5, 5) and h.dtype == torch.int32


# Reference exports not ported yet, each with the ROADMAP Queue 1 item
# that ports it.  Everything else the reference's packages export must
# import from the port's package of the same name.
NOT_PORTED = {
    "core": {},
    "data": {},
    "kernels": {},
    "serving": {},
    "persist": {},
    "checkpoint": {},
    "optim": {},
    "runtime": {},
    "models": {},
    "launch": {},
    "analysis": {},
}


def _reference_all(pkg):
    """The reference package's ``__all__``, read from its source (no jax
    import)."""
    tree = ast.parse((_REPO / "src" / "repro" / pkg / "__init__.py")
                     .read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"repro.{pkg} has no __all__")


@pytest.mark.parametrize("pkg", sorted(NOT_PORTED))
def test_port_exports_what_the_reference_exports(pkg):
    import importlib
    mod = importlib.import_module(f"repro_torch.{pkg}")
    ref_all = _reference_all(pkg)
    missing = [n for n in ref_all
               if not hasattr(mod, n) and n not in NOT_PORTED[pkg]]
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    stale = [n for n in NOT_PORTED[pkg] if hasattr(mod, n)
             or n not in ref_all]
    assert not stale, f"allowance of repro_torch.{pkg} out of date: {stale}"
    assert set(ref_all) - set(NOT_PORTED[pkg]) <= set(mod.__all__)


def test_kernel_entry_points_are_their_modules():
    """``repro_torch.kernels.lsh_hash`` is the wrapper's module and the
    reference's entry point at once: calling it runs ``ops.lsh_hash``."""
    from repro_torch import kernels
    from repro_torch.kernels import lsh_hash, ops
    g = torch.Generator().manual_seed(0)
    x, a = torch.randn((6, 8), generator=g), torch.randn((8, 3), generator=g)
    b = torch.zeros(3)
    assert lsh_hash is kernels.lsh_hash and hasattr(lsh_hash, "plan")
    assert torch.equal(lsh_hash(x, a, b, w=0.5),
                       ops.lsh_hash(x, a, b, w=0.5))


def test_simulator_oracle_and_datasets_without_device_need_a_card():
    from repro_torch.core import (Scheme, lsh_topk_reference,
                                  nearest_neighbors, simulate,
                                  simulate_stream)
    from repro_torch.core.simulate import make_sim
    from repro_torch.data import dedup_embeddings, planted_random
    cfg = LSHConfig(d=8, k=4, W=1.0, r=0.3, c=2.0, L=2, n_shards=2,
                    scheme=Scheme.LAYERED)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    for fn in (lambda **kw: make_sim(cfg, **kw),
               lambda **kw: simulate(cfg, x, x[:4], **kw),
               lambda **kw: simulate_stream(cfg, x, x[:4], 16, 8, 4, **kw),
               lambda **kw: lsh_topk_reference(cfg, x, x[:4], 2, **kw),
               lambda **kw: nearest_neighbors(x, x[:4], 2, **kw),
               lambda **kw: planted_random(32, 4, d=8, **kw),
               lambda **kw: dedup_embeddings(x, r=0.3, **kw)):
        _needs_a_card(fn, lambda: fn(device="cpu"))


def test_contract_gate_and_serving_example_without_device_need_a_card(
        tmp_path):
    import importlib.util
    from repro_torch.analysis import check
    report = str(tmp_path / "report.json")
    # the lint and the shared-memory plans need no device
    assert check.main(["--skip-trace", "--json", report]) == 0
    spec = importlib.util.spec_from_file_location(
        "serve_retrieval_torch", _REPO / "examples" / "serve_retrieval_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check.main(["--json", report])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--arch", "mamba2-130m", "--docs", "64"])
