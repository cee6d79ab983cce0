"""The port's contract gate: ``python -m repro_torch.analysis.check``.

Builds the real ``DistributedLSHIndex`` at the manifest's
``check_config`` (8 shards, T = 1, 2, 4) on the card, or on the CPU with
``--device cpu``, inserts ``data[:m]``, queries the ``m`` queries,
deletes 8 gids and runs the staged query's three stages, each phase
under the trace pass; then the device pass (store columns in place, the
bucket kernels' shared memory, and on the card each phase's host syncs
and allocator peak) and the lint, against ``contracts.json`` next to
this module.  It writes a JSON report and exits nonzero on any
violation.

``--seed-violation`` injects one violation of each of the reference's
four classes, as the port has them, so that the gate stays falsifiable:
``extra-collective`` (a third exchange after the query),
``broken-donation`` (the insert clones a store column),
``jaxpr-growth`` (per-table ops added to the query) and ``host-sync``
(a hot-path file, written to a temporary directory).  ``--skip-trace``
runs the lint and the shared-memory plans only, with no device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import Any, Dict, List

from repro_torch.analysis import manifest, repolint

SEEDABLE = ("extra-collective", "broken-donation", "jaxpr-growth", "host-sync")

_SEEDED_HOT_FILE = """\
def top_score(scores):
    # seeded violation: a host sync inside a kernel module
    return scores.max().item()
"""
_SEEDED_HOT_PATH = "src/repro_torch/kernels/seeded_hot_path.py"


def _run_repolint(contracts: Dict[str, Any], root: str,
                  seed: str | None) -> Dict[str, Any]:
    report = repolint.scan(root, contracts)
    if seed == "host-sync":
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, _SEEDED_HOT_PATH)
            os.makedirs(os.path.dirname(path))
            with open(path, "w") as f:
                f.write(_SEEDED_HOT_FILE)
            extra = repolint.scan_files([path], contracts["repolint"],
                                        rel_root=tmp)
        report["violations"].extend(v.as_dict() for v in extra)
        report["files_scanned"] += 1
    return report


def _run_trace(contracts: Dict[str, Any], dev, seed: str | None,
               report: Dict[str, Any]) -> List[str]:
    """Every phase at every T of the check config; returns the
    violations and fills ``report["trace"]``."""
    import numpy as np
    import torch

    from repro_torch.analysis import device_pass, trace_pass
    from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme
    from repro_torch.data import planted_random

    cuda = dev.type == "cuda"
    cc = contracts["check_config"]
    S, m, K = int(cc["n_shards"]), int(cc["m"]), int(cc["k_neighbors"])
    hlo_T = int(cc["hlo_tables"])
    data, queries, _ = planted_random(n=cc["n"], m=m, d=cc["d"], r=cc["r"],
                                      seed=cc["seed"], device=dev)
    victims = np.arange(8)
    columns = sorted({c for k, cols in contracts["device"]["in_place"].items()
                      if not k.startswith("_") for c in cols})

    violations: List[str] = []
    phases: Dict[str, Dict[str, Any]] = {p: {} for p in manifest.PHASES}
    ops: Dict[str, Dict[int, int]] = {p: {} for p in manifest.PHASES}

    for T in cc["tables"]:
        cfg = LSHConfig(d=cc["d"], k=cc["k"], W=cc["W"], r=cc["r"],
                        c=cc["c"], L=cc["L"], n_shards=S,
                        scheme=Scheme.LAYERED, seed=cc["seed"], n_tables=T)
        idx = DistributedLSHIndex(cfg, device=dev, k_neighbors=K)
        # room for the insert: its columns are checked at a fixed
        # capacity, as the reference traces its insert at one
        idx.build(data, capacity=idx._store_capacity((cc["n"] + m) * T))

        def run(phase, fn, in_place=False):
            st = idx.store
            before = device_pass.column_storages(st, columns)
            cap = st.capacity
            tr = trace_pass.trace(idx, fn,
                                  device_pass.SyncLog() if cuda else None)
            rep = trace_pass.analyze_phase(tr, phase, T, contracts)
            if in_place:
                rep["in_place"] = device_pass.in_place_report(
                    before, device_pass.column_storages(idx.store, columns),
                    cap, idx.store.capacity, phase, T, contracts)
                rep["violations"] += rep["in_place"]["violations"]
            if cuda:
                rep["host_syncs"] = device_pass.sync_report(
                    tr.syncs, phase, T, contracts)
                rep["violations"] += rep["host_syncs"]["violations"]
                if T == hlo_T:
                    rep["memory"] = device_pass.memory_report(
                        tr.temp_bytes, S, phase, contracts)
                    rep["violations"] += rep["memory"]["violations"]
            phases[phase][str(T)] = rep
            ops[phase][T] = tr.ops
            violations.extend(rep["violations"])
            return tr.out

        def insert():
            if seed == "broken-donation":
                idx.store = dataclasses.replace(idx.store,
                                                x=idx.store.x.clone())
            return idx.insert(data[:m])

        def query():
            res = idx.query(queries)
            if seed == "jaxpr-growth":
                x = torch.zeros((), device=dev)
                for _ in range(120 * (T - 1)):
                    x = torch.sin(x)
            elif seed == "extra-collective" and T == hlo_T:
                idx.a2a(torch.zeros((S, S, 1), dtype=torch.int32,
                                    device=dev))
            return res

        ins = run("insert", insert, in_place=True)
        res = run("query", query)
        dele = run("delete", lambda: idx.delete(victims), in_place=True)
        disp = run("query_dispatch", lambda: idx.query_dispatch(queries))
        scanned = run("query_scan", lambda: idx.query_scan(disp))
        run("query_return", lambda: idx.query_return(scanned))
        if ins.drops or res.drops or dele.n_points != len(victims):
            violations.append(
                f"T={T}: the check config's phases did not run clean "
                f"(insert drops {ins.drops}, query drops {res.drops}, "
                f"deleted {dele.n_points} of {len(victims)} gids)")

    ratio = manifest.flatness_ratio(contracts)
    flat = {"max_ratio": ratio, "ops": {}}
    for phase, by_T in ops.items():
        flat["ops"][phase] = {str(t): n for t, n in by_T.items()}
        violations.extend(trace_pass.check_flatness(by_T, ratio, phase))
    report["trace"] = {"device": str(dev), "phases": phases,
                       "flatness": flat}
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="The port's contract gate (trace pass, device pass, "
                    "lint) against src/repro_torch/analysis/"
                    "contracts.json.")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--json", dest="json_out",
                    default="contracts_report_torch.json",
                    help="report path (default: %(default)s)")
    ap.add_argument("--repo-root", default=None,
                    help="repo root for the lint pass (default: inferred)")
    ap.add_argument("--seed-violation", choices=SEEDABLE, default=None,
                    help="inject one violation of the given class "
                         "(self-test that the gate actually fails)")
    ap.add_argument("--skip-trace", action="store_true",
                    help="lint + shared-memory plans only (no device)")
    args = ap.parse_args(argv)

    contracts = manifest.load_contracts()
    root = args.repo_root or manifest.repo_root()
    report: Dict[str, Any] = {
        "schema": 1,
        "contracts": manifest.CONTRACTS_PATH,
        "check_config": contracts["check_config"],
        "seed_violation": args.seed_violation,
    }
    violations: List[str] = []

    lint = _run_repolint(contracts, root, args.seed_violation)
    report["repolint"] = lint
    violations.extend(f"repolint: {v['path']}:{v['line']}: [{v['rule']}] "
                      f"{v['msg']}" for v in lint["violations"])

    from repro_torch.analysis import device_pass
    if args.skip_trace:
        report["smem"] = device_pass.smem_report(contracts)
    else:
        from repro_torch.core.index import resolve_device
        from repro_torch.kernels import bucket_search as kbs
        dev = resolve_device(args.device)
        report["smem"] = device_pass.smem_report(
            contracts, kbs._lib() if dev.type == "cuda" else None)
        violations.extend(_run_trace(contracts, dev, args.seed_violation,
                                     report))
    violations.extend(report["smem"]["violations"])

    report["violations"] = violations
    report["ok"] = not violations
    with open(args.json_out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)

    if violations:
        print(f"CONTRACT VIOLATIONS ({len(violations)}):")
        for v in violations:
            print(f"  - {v}")
    else:
        ph = report.get("trace", {}).get("phases", {})
        for phase in manifest.PHASES:
            for t, rep in sorted(ph.get(phase, {}).items()):
                syncs = rep.get("host_syncs", {}).get("count")
                top = rep["max_intermediate"]
                print(f"  ok {phase:14s} T={t}: {rep['ops']:4d} ops, "
                      f"collectives {rep['collectives'] or '{}'}, largest "
                      f"{top['numel']} ({top['op']})"
                      + ("" if syncs is None else f", host syncs {syncs}"))
        sm = report["smem"]
        print(f"  ok smem: bucket_search {sm['largest']['bucket_search']}, "
              f"bucket_gather {sm['largest']['bucket_gather']} <= "
              f"{sm['budget_bytes']} bytes"
              + (" (== the library's)" if sm["library_checked"] else ""))
        print(f"  ok repolint: {lint['files_scanned']} files clean")
        print("all contracts hold")
    print(f"report: {args.json_out}")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
