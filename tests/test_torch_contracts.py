"""The port's contract gate (``repro_torch.analysis``) on the CPU.

  * the port's manifest carries the reference's budgets as they are,
    wherever the two share one;
  * ``check_collectives`` and ``check_flatness`` on the reference test's
    own cases, equal to the reference's functions;
  * every lint rule fires on an in-memory source and stays quiet on its
    allowed form, and the port's lint is clean on the repository;
  * the trace pass: a hand-written kernel's call is one op, and the gate
    on the CPU shows insert 1, query 2, delete 0 and stages 1/0/1
    exchanges at T = 1, 2, 4, flat within the manifest's ratio, every
    phase within its per-table ceiling, 32-bit payloads on the wire and
    the store columns written in place;
  * ``check.main(["--device", "cpu"])`` returns 0, and each seeded
    violation class returns nonzero with a violation naming its contract.
"""
import json

import pytest
import torch

from repro.analysis import jaxpr_pass
from repro.analysis import load_contracts as load_reference
from repro_torch.analysis import (check, device_pass, load_contracts,
                                  repo_root, repolint, trace_pass)
from repro_torch.analysis.manifest import PHASES, flatness_ratio
from test_torch_cuda import one_torch_thread  # noqa: F401

CONTRACTS = load_contracts()
REFERENCE = load_reference()
LINT = CONTRACTS["repolint"]
ALLOWED = CONTRACTS["host_syncs"]["allowed"]


def _budgets(section):
    return {k: v for k, v in section.items() if not k.startswith("_")}


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------

def test_manifest_carries_the_references_budgets():
    assert _budgets(CONTRACTS["check_config"]) == _budgets(
        REFERENCE["check_config"])
    tc, jc = CONTRACTS["trace"], REFERENCE["jaxpr"]
    assert {p: _budgets(b) for p, b in _budgets(tc["collectives"]).items()} \
        == {p: _budgets(b) for p, b in _budgets(jc["collectives"]).items()}
    assert flatness_ratio(CONTRACTS) == REFERENCE["jaxpr"]["flatness"][
        "max_ratio"] == 1.15
    assert _budgets(tc["max_intermediate_numel_per_table"]) == _budgets(
        jc["max_intermediate_numel_per_table"])
    assert tc["forbid_wide_dtypes"] == jc["forbid_wide_dtypes"]
    assert _budgets(CONTRACTS["device"]["temp_bytes_ceiling"]) == _budgets(
        REFERENCE["hlo"]["temp_bytes_ceiling"])
    env = ("d_max", "L_max", "k_neighbors_max")
    assert ({k: CONTRACTS["smem"][k] for k in env}
            == {k: REFERENCE["vmem"][k] for k in env})
    # insert donates the six store columns; the port writes them in place
    cols = CONTRACTS["device"]["in_place"]["insert"]
    assert len(cols) == REFERENCE["hlo"]["donation"][
        "insert_min_aliased_params"] == 6
    assert set(cols) <= set(REFERENCE["repolint"]["store_columns"])
    assert LINT["deprecated_attrs"] == REFERENCE["repolint"][
        "deprecated_attrs"]
    # the budgets of the port's own, each against its reason
    from repro_torch.kernels.bucket_search import SMEM_LIMIT
    assert CONTRACTS["smem"]["budget_bytes"] == SMEM_LIMIT == 232448
    for name, entry in ALLOWED.items():
        assert entry["reason"] and entry["function"], name
    for phase in PHASES:
        assert set(CONTRACTS["host_syncs"]["phases"][phase]) <= set(ALLOWED)


def test_manifest_loader_refuses_a_broken_manifest(tmp_path):
    bad = json.loads(json.dumps(CONTRACTS))
    bad["host_syncs"]["phases"]["query"].append("no-such-sync")
    path = tmp_path / "contracts.json"
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="unknown host syncs"):
        load_contracts(str(path))
    bad = json.loads(json.dumps(CONTRACTS))
    del bad["trace"]["collectives"]["delete"]
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="delete"):
        load_contracts(str(path))


# ---------------------------------------------------------------------------
# collectives and flatness: the reference test's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", [trace_pass, jaxpr_pass],
                         ids=["port", "reference"])
def test_unbudgeted_collective_kind_fails_closed(impl):
    viol = impl.check_collectives({"ppermute": 1}, {"all_to_all": 2})
    assert any("ppermute" in v for v in viol)
    # exact match: too FEW is also a violation (the fused a2a vanished)
    viol = impl.check_collectives({}, {"all_to_all": 2})
    assert any("all_to_all" in v for v in viol)
    assert impl.check_collectives({"all_to_all": 2},
                                  {"all_to_all": 2, "_comment": "x"}) == []


def test_collective_checks_agree_with_the_reference():
    for counts, budget in (({"all_to_all": 3}, {"all_to_all": 2}),
                           ({"all_gather": 1}, {"all_to_all": 2}),
                           ({}, {})):
        assert trace_pass.check_collectives(counts, budget, "q") == \
            jaxpr_pass.check_collectives(counts, budget, "q")


@pytest.mark.parametrize("impl", [trace_pass, jaxpr_pass],
                         ids=["port", "reference"])
def test_flatness_check(impl):
    ratio = flatness_ratio(CONTRACTS)
    assert impl.check_flatness({1: 800, 2: 804, 4: 806}, ratio) == []
    viol = impl.check_flatness({1: 800, 4: 1600}, ratio, "query")
    assert viol and "not flat" in viol[0]


# ---------------------------------------------------------------------------
# the lint, rule by rule, both ways
# ---------------------------------------------------------------------------

def _lint(src, path="src/repro_torch/serving/x.py", used=None):
    return repolint.lint_source(src, path, LINT, ALLOWED, used)


HOT = "src/repro_torch/kernels/util.py"
INDEX = "src/repro_torch/core/index.py"


@pytest.mark.parametrize("body,n_flagged", [
    ("return x.sum().item()", 1),
    ("return x.cpu()", 1),
    ("return x.cpu().numpy()", 1),          # one copy, one sync
    ("return x.tolist()", 1),
    ("return np.asarray(x)", 1),
    ("return torch.nonzero(x)", 1),
    ("torch.cuda.synchronize()", 1),
    ("return int(x.sum(dim=-1).max())", 1),
    ("return bool(x.any())", 1),
    ("return int(x.item())", 1),             # the .item() alone
    ("h = x.numpy()\n    return int(h.sum())", 1),   # the .numpy() only
    ("return int(np.float32(3.5))", 0),
    ("return int(len(x))", 0),
    ("return float(w)", 0),
    ("return x.sum(dim=-1)", 0),
    # index_put_ of a Python scalar copies it to the card first
    ("x[i] = True", 1),
    ("x[i, j] = -1", 1),
    ("x[:, i] = 0.5", 1),
    ("x[:, :3] = 0", 0),
    ("x[0] = 1.5", 0),
    ("x[i, j] = torch.ones_like(i, dtype=torch.bool)", 0),
])
def test_host_sync_rule(body, n_flagged):
    src = f"import numpy as np\nimport torch\ndef f(x, w):\n    {body}\n"
    hot = _lint(src, HOT)
    assert [v.rule for v in hot] == ["host-sync"] * n_flagged, hot
    # the same code outside a hot scope is fine
    assert _lint(src) == []


def test_host_sync_scopes():
    src = ("class DistributedLSHIndex:\n"
           "    def _scan(self, r):\n"
           "        return int(r.sum().max())\n"
           "    def query(self, q):\n"
           "        return int(q.sum().max())\n")
    viol = _lint(src, INDEX)
    assert [(v.rule, v.line) for v in viol] == [("host-sync", 3)], viol
    # a function nested in a hot method is hot; module level is setup
    nested = ("class DistributedLSHIndex:\n"
              "    def _insert(self, x):\n"
              "        def count(y):\n"
              "            return y.cpu()\n"
              "        return count(x)\n")
    assert len(_lint(nested, INDEX)) == 1
    assert _lint("import torch\nA = torch.ones(2).cpu()\n", HOT) == []
    # the reference's step-closure names mean nothing to the port's lint
    assert _lint("import numpy as np\ndef query_shard(b):\n"
                 "    return np.asarray(b)\n") == []


def test_host_sync_allowed_by_name_only_where_the_manifest_says():
    body = ("class DistributedLSHIndex:\n"
            "    def _scan(self, r):\n"
            "        # host-sync: {name}\n"
            "        return int(r.sum().max())\n")
    used = set()
    assert _lint(body.format(name="scan-live-rows"), INDEX, used) == []
    assert used == {"scan-live-rows"}
    # a trailing comment on the statement works too
    trailing = ("class DistributedLSHIndex:\n"
                "    def _scan(self, r):\n"
                "        return int(r.sum().max())  # host-sync: "
                "scan-live-rows\n")
    assert _lint(trailing, INDEX) == []
    wrong = _lint(body.format(name="insert-stats"), INDEX)
    assert len(wrong) == 1 and "allowed in DistributedLSHIndex._insert" \
        in wrong[0].msg
    unknown = _lint(body.format(name="made-up"), INDEX)
    assert len(unknown) == 1 and "no entry" in unknown[0].msg


def test_stale_allowance_is_a_violation(tmp_path):
    contracts = json.loads(json.dumps(CONTRACTS))
    contracts["host_syncs"]["allowed"]["unused-sync"] = {
        "function": "DistributedLSHIndex._scan", "lint": True,
        "reason": "test"}
    contracts["repolint"]["scan"] = ["src/repro_torch/core/index.py"]
    report = repolint.scan(repo_root(), contracts)
    assert [v["msg"] for v in report["violations"]
            if "unused-sync" in v["msg"]], report


@pytest.mark.parametrize("src,path,rule", [
    ("def f(r):\n    return r.best_dist\n", None, "deprecated-shim"),
    ("def f(i):\n    return i.table_params\n", None, "deprecated-shim"),
    ("def f(q, s):\n    return QueryBatch(q, s)\n", None,
     "kw-only-kernel-api"),
    ("def f(q, s):\n    return ops.bucket_search(q, s)\n", None,
     "kw-only-kernel-api"),
    ("def f(x, p):\n    return StoreState(x, p)\n", None, "store-mutation"),
    ("def f(st, m):\n    st.valid = m\n", None, "store-mutation"),
    ("def f(st, m):\n    st.psq = m\n", None, "store-mutation"),
])
def test_lint_rules_fire_outside_their_owners(src, path, rule):
    viol = _lint(src, path or "src/repro_torch/launch/x.py")
    assert [v.rule for v in viol] == [rule], viol
    owner = {"deprecated-shim": INDEX, "kw-only-kernel-api":
             "src/repro_torch/kernels/types.py",
             "store-mutation": "src/repro_torch/core/store_layout.py"}[rule]
    assert _lint(src, owner) == []


def test_keyword_calls_pass():
    src = ("def f(q, s):\n"
           "    b = QueryBatch(q=q, qsq=q, buckets=s, probe=s, table=s)\n"
           "    return ops.bucket_search(query=b, store=s, cr2=1.0, L=2)\n")
    assert _lint(src) == []


def test_port_lint_is_clean_on_the_repo():
    report = repolint.scan(repo_root(), CONTRACTS)
    assert report["files_scanned"] > 100
    assert report["violations"] == [], report["violations"]
    assert set(report["allowances_used"]) == {
        n for n, e in ALLOWED.items() if e["lint"]}


# ---------------------------------------------------------------------------
# the trace pass
# ---------------------------------------------------------------------------

def test_a_kernel_call_counts_as_one_op():
    from repro_torch.kernels import bucket_search as kbs
    from repro_torch.kernels import watch
    from repro_torch.kernels.types import QueryBatch, StoreView
    from test_torch_cuda import case, to_torch
    L, cr2 = 4, 16.0
    query, store = to_torch(case(0, 32, 256, 8, L, frac_match=0.5))
    one = lambda v: v if v is None or isinstance(v, int) else v[None]
    query = QueryBatch(**{f: one(v) for f, v in vars(query).items()})
    store = StoreView(**{f: one(v) for f, v in vars(store).items()})

    counter = trace_pass.OpCounter()
    with watch.watching(counter), counter:
        got = kbs.bucket_search_cuda(query=query, store=store, cr2=cr2,
                                     L=L, K=4)
    assert counter.by_op == {"kernel:bucket_search": 1}, counter.by_op
    assert counter.ops == 1
    assert counter.top["numel"] == max(t.numel() for t in got)
    # unwatched, its plain version is many ops and (rows, chunk) temps
    plain = trace_pass.OpCounter()
    with plain:
        kbs.bucket_search_cuda(query=query, store=store, cr2=cr2, L=L, K=4)
    assert plain.ops > 20 and plain.top["numel"] > counter.top["numel"]


def test_views_are_not_intermediates():
    x = torch.zeros((64, 64))
    counter = trace_pass.OpCounter()
    with counter:
        x.reshape(-1)[:10]
        x.t()
    assert counter.ops == 3 and counter.top["numel"] == 0
    with counter:
        x.t().contiguous()
    assert counter.top["numel"] == 64 * 64


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gate") / "report.json")
    assert check.main(["--device", "cpu", "--json", out]) == 0
    with open(out) as f:
        return json.load(f)


def test_gate_passes_on_the_cpu(report):
    assert report["ok"] and report["violations"] == []
    assert report["trace"]["device"] == "cpu"


def test_exchanges_flatness_and_ceilings_at_every_T(report):
    ph = report["trace"]["phases"]
    want = {"insert": 1, "query": 2, "delete": 0, "query_dispatch": 1,
            "query_scan": 0, "query_return": 1}
    ratio = report["trace"]["flatness"]["max_ratio"]
    for phase, n in want.items():
        assert sorted(ph[phase]) == ["1", "2", "4"]
        for T, rep in ph[phase].items():
            assert rep["collectives"] == ({"all_to_all": n} if n else {})
            top = rep["max_intermediate"]
            assert 0 < top["numel"] <= rep["max_intermediate_ceiling"] == (
                CONTRACTS["trace"]["max_intermediate_numel_per_table"][phase]
                * int(T))
            assert all(p["itemsize"] == 4 for p in rep["wire"])
            assert len(rep["wire"]) == n
        ops = report["trace"]["flatness"]["ops"][phase]
        assert max(ops.values()) <= ratio * min(ops.values()), (phase, ops)
    # the query launches the bucket kernel and the hash kernel, each one op
    kernels = ph["query_scan"]["2"]["kernels"]
    assert kernels.get("bucket_search") == 1 and kernels.get("lsh_hash") >= 1


def test_store_columns_written_in_place(report):
    for phase in ("insert", "delete"):
        for T, rep in report["trace"]["phases"][phase].items():
            ip = rep["in_place"]
            assert ip["moved"] == [] and ip["violations"] == []
            assert ip["capacity"][0] == ip["capacity"][1]
            assert set(ip["columns"]) == set(
                CONTRACTS["device"]["in_place"][phase])
    before = {"x": 1, "valid": 2}
    rep = device_pass.in_place_report(before, {"x": 3, "valid": 2}, 8, 8,
                                      "insert", 2,
                                      {"device": {"in_place": {
                                          "insert": ["x", "valid"]}}})
    assert rep["moved"] == ["x"] and "in place" in rep["violations"][0]


def test_shared_memory_within_the_h100s_budget(report):
    sm = report["smem"]
    assert sm["violations"] == [] and not sm["library_checked"]
    assert 0 < sm["largest"]["bucket_search"] <= sm["budget_bytes"]
    assert 0 < sm["largest"]["bucket_gather"] <= sm["budget_bytes"]
    tight = json.loads(json.dumps(CONTRACTS))
    tight["smem"]["budget_bytes"] = 1024
    assert device_pass.smem_report(tight)["violations"]


def test_memory_and_sync_reports():
    rep = device_pass.memory_report(8 * 600000, 8, "query_dispatch",
                                    CONTRACTS)
    assert rep["violations"] and rep["temp_bytes_per_shard"] == 600000
    assert device_pass.memory_report(8 * 500000, 8, "query_dispatch",
                                     CONTRACTS)["violations"] == []
    syncs = [{"function": "DistributedLSHIndex._scan", "where": "x:1"}]
    assert device_pass.sync_report(syncs, "query_scan", 2,
                                   CONTRACTS)["violations"] == []
    assert device_pass.sync_report(syncs * 2, "query_scan", 2,
                                   CONTRACTS)["violations"]
    assert device_pass.sync_report(syncs, "query_dispatch", 2,
                                   CONTRACTS)["violations"]


# ---------------------------------------------------------------------------
# the gate falsifiable: every seeded class fails, naming its contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,needle,extra", [
    ("extra-collective", "all_to_all x3", []),
    ("broken-donation", "not written in place", []),
    ("jaxpr-growth", "not flat", []),
    ("host-sync", "[host-sync]", ["--skip-trace"]),
])
def test_seeded_violation_fails_the_gate(tmp_path, seed, needle, extra):
    out = str(tmp_path / "report.json")
    rc = check.main(["--device", "cpu", "--json", out,
                     "--seed-violation", seed, *extra])
    assert rc != 0
    with open(out) as f:
        rep = json.load(f)
    assert not rep["ok"]
    assert any(needle in v for v in rep["violations"]), rep["violations"]


def test_skip_trace_needs_no_device_and_passes(tmp_path):
    out = str(tmp_path / "report.json")
    assert check.main(["--skip-trace", "--json", out]) == 0
    with open(out) as f:
        rep = json.load(f)
    assert rep["ok"] and "trace" not in rep
    assert rep["repolint"]["files_scanned"] > 100
