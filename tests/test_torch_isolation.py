"""The port stands alone: no jax, no reference package, no silent CPU.

Importing every module of ``repro_torch`` (in a fresh interpreter) must
leave ``jax`` and ``repro`` out of ``sys.modules``, and no line of the
port or of ``chip_smoke.py`` may import them.  An index built without a
``device`` on a machine with no card raises instead of running on the
CPU.
"""
import ast
import os
import pathlib
import subprocess
import sys

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
    assert "repro_torch.core.index" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(_REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(_REPO)) for p in _PORT.rglob("*.py")]
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
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_index_without_device_needs_a_card():
    cfg = LSHConfig(d=8, k=4, W=1.0, r=0.3, c=2.0, L=2, n_shards=2)
    if torch.cuda.is_available():
        assert DistributedLSHIndex(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DistributedLSHIndex(cfg)
    assert DistributedLSHIndex(cfg, device="cpu").device.type == "cpu"


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
