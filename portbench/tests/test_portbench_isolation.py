"""What a run loads: no JAX and not the reference package ``repro``
(compared by whole top-level name: ``repro_torch`` begins with
``repro``), and a plain reference that imports nothing of the program."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "portbench" / "reference"
PROGRAM = ("repro_torch", "repro", "jax", "jaxlib", "flax")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    files = sorted(REFERENCE.glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in PROGRAM, (f.name, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (f.name, name)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core_probe", object())
    assert "repro" in run.forbidden_modules()


def test_a_run_loads_no_jax_and_not_repro():
    code = (
        "import json, sys; sys.path[:0] = [%r, %r, %r]\n"
        "from conftest import tiny_cell\n"
        "from portbench import run\n"
        "r = run.run_cell(tiny_cell('serve-d64.stream'), 5, 1.0, False,"
        " device='cpu')\n"
        "print(json.dumps({'failed': r['failed'],"
        " 'found': run.forbidden_modules()}))\n"
        % (str(ROOT / "portbench" / "tests"), str(ROOT), str(ROOT / "src")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"failed": 0, "found": []}
