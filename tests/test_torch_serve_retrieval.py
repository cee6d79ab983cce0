"""The streaming serving driver: ``examples/serve_retrieval_torch.py``
against the reference's ``examples/serve_retrieval.py``.

The reference's example runs in one subprocess with 8 placeholder host
devices, twice on one snapshot directory (cold with ``--steps 2``, then
a warm restart with ``--steps 3`` that resumes the stream at step 2),
with mamba2-130m's reduced config; the run records its weights, the
documents it indexed and inserted, and each step's query tokens, answers
and rows a query.  The port's example replays both runs on the CPU with
those weights (``convert.model_params_from_arrays``), ``--pipelined``:
  * the drawn tokens -- the corpus, each step's sources, perturbed
    positions and new tokens -- are bitwise the reference's;
  * each step's new gids, top-K gids, self-retrieval counts and rows a
    query are equal, squared distances within rtol = atol = 1e-5 (the
    kernels' tolerance, which is on d^2);
  * the warm run restores the same rows and resumes at the same step.
"""
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mamba2-130m"
FLAGS = ["--arch", ARCH, "--docs", "256", "--batch-size", "64",
         "--insert-size", "64"]
# the port serves through its async front, whose answers are bitwise the
# synchronous service's (test_torch_serving_pipeline.py); the reference
# runs synchronously, which spares it the staged stages' compiles
PORT_FLAGS = FLAGS + ["--pipelined"]
RUNS = (("cold", 2), ("warm", 3))          # (run, --steps)

_SCRIPT = """
import os, runpy, sys
import jax, numpy as np
import repro.models
from repro.serving import RetrievalService

out_dir, example, snap = sys.argv[1:4]
flags = sys.argv[4:]
rec = {}
_init = repro.models.init_params
def init_params(key, cfg):
    params = _init(key, cfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        rec["w/" + name] = np.asarray(leaf)
    return params
repro.models.init_params = init_params
_rob = RetrievalService.recover_or_build.__func__
def recover_or_build(cls, cfg, params, doc_tokens, mesh, **kw):
    rec["docs"] = np.asarray(doc_tokens)
    svc, rr = _rob(cls, cfg, params, doc_tokens, mesh, **kw)
    rec["n_live"] = np.int64(svc.index.n_live)
    return svc, rr
RetrievalService.recover_or_build = classmethod(recover_or_build)
_insert = RetrievalService.insert_docs
def insert_docs(self, tokens):
    gids = _insert(self, tokens)
    i = sum(k.startswith("new_gids") for k in rec)
    rec[f"inserted{i}"] = np.asarray(tokens)
    rec[f"new_gids{i}"] = np.asarray(gids)
    return gids
RetrievalService.insert_docs = insert_docs
_query = RetrievalService.query
def query(self, qtok):
    gids, dists, handles = _query(self, qtok)
    i = sum(k.startswith("gids") for k in rec)
    rec[f"qtok{i}"] = np.asarray(qtok)
    rec[f"gids{i}"], rec[f"dists{i}"] = gids, dists
    rec[f"fq{i}"] = np.array([h.fq for h in handles])
    return gids, dists, handles
RetrievalService.query = query
for run, steps in RUNS:
    rec.clear()
    print("=== " + run, flush=True)
    sys.argv = [example, *flags, "--steps", str(steps),
                "--snapshot-dir", snap]
    runpy.run_path(example, run_name="__main__")
    np.savez(os.path.join(out_dir, run + ".npz"), **rec)
print("OK")
"""


def _load_example():
    path = os.path.join(_REPO, "examples", "serve_retrieval_torch.py")
    spec = importlib.util.spec_from_file_location("serve_retrieval_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(rec):
    """The flat "w/<path>" arrays -> the reference's nested params."""
    root = {}
    for name, a in rec.items():
        if not name.startswith("w/"):
            continue
        *path, leaf = name[2:].split("/")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    root["segments"] = [root["segments"][str(i)]
                        for i in range(len(root["segments"]))]
    return root


def _step_lines(out):
    """(step, rows/query, self-retrieval, in top-K) of each printed step
    line, and the step a run resumed at (0 on a cold run)."""
    steps = [(int(b), rq, int(h), int(t)) for b, rq, h, t in re.findall(
        r"\[serve\] step (\d+): .* rows/query=([\d.]+) "
        r"self-retrieval=(\d+)/\d+ \(in top-\d+: (\d+)\)", out)]
    resumed = re.findall(r"resuming stream at step (\d+)", out)
    return steps, int(resumed[0]) if resumed else 0


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_serve")
    snap = tmp_path_factory.mktemp("ref_snap")
    env = dict(os.environ)
    # one compute thread: the suite runs in parallel workers
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false")
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    example = os.path.join(_REPO, "examples", "serve_retrieval.py")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.replace("RUNS", repr(RUNS)),
         str(out), example, str(snap), *FLAGS],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    printed = dict(zip(("cold", "warm"),
                       proc.stdout.split("=== warm")))
    return {run: (dict(np.load(out / f"{run}.npz")), printed[run])
            for run, _ in RUNS}


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    mod = _load_example()
    cfg = get_config(ARCH, reduced=True)
    rec, _ = reference["cold"]
    model = convert.model_params_from_arrays(_tree(rec), cfg, device="cpu")
    snap = tmp_path_factory.mktemp("port_snap")
    out = {}
    for run, steps in RUNS:
        args = mod.parse([*PORT_FLAGS, "--steps", str(steps), "--device",
                          "cpu", "--snapshot-dir", str(snap)])
        out[run] = (args, mod.serve(args, cfg, model))
    return mod, cfg, out


def test_drawn_tokens_are_bitwise_the_references(reference, port):
    mod, cfg, out = port
    rec, _ = reference["cold"]
    args, _ = out["warm"]
    docs = mod.corpus(args, cfg.vocab).numpy()
    np.testing.assert_array_equal(docs[:args.docs], rec["docs"])
    for run, _ in RUNS:
        rec, _ = reference[run]
        _, got = out[run]
        inserted = sorted(k for k in rec if k.startswith("inserted"))
        assert len(inserted) == len(got["steps"])
        for key, step in zip(inserted, got["steps"]):
            lo = args.docs + step["step"] * args.insert_size
            np.testing.assert_array_equal(
                docs[lo:lo + args.insert_size], rec[key])
        for i, step in enumerate(got["steps"]):
            np.testing.assert_array_equal(step["qtok"], rec[f"qtok{i}"])


def test_each_step_answers_as_the_reference(reference, port):
    _, _, out = port
    for run, _ in RUNS:
        rec, printed = reference[run]
        _, got = out[run]
        want_lines, _ = _step_lines(printed)
        assert len(got["steps"]) == len(want_lines) > 0, run
        for i, (step, line) in enumerate(zip(got["steps"], want_lines)):
            b, rows_per_query, hits, topk_hits = line
            assert step["step"] == b
            np.testing.assert_array_equal(step["new_gids"],
                                          rec[f"new_gids{i}"])
            np.testing.assert_array_equal(step["gids"], rec[f"gids{i}"])
            np.testing.assert_allclose(step["dists"] ** 2,
                                       rec[f"dists{i}"] ** 2,
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(step["fq"], rec[f"fq{i}"])
            assert (step["batch_hits"], step["topk_hits"]) == (hits,
                                                               topk_hits)
            assert f"{step['fq'].mean():.2f}" == rows_per_query
        assert got["drops"] == 0


def test_warm_restart_resumes_at_the_references_step(reference, port):
    _, _, out = port
    rec, printed = reference["warm"]
    _, got = out["warm"]
    _, resumed = _step_lines(printed)
    assert "WARM restart" in printed
    assert got["warm"] is not None and got["resumed_at"] == resumed == 2
    assert got["rows_at_start"] == int(rec["n_live"]) == 256 + 2 * 64
    assert out["cold"][1]["warm"] is None
