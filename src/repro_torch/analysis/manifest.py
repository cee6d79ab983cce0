"""Contract manifest loader (torch-free; safe to import anywhere).

The manifest -- ``contracts.json`` next to this module -- is the port's
single committed source of every budget its gate checks: per-phase
exchange counts, flatness in T, intermediate ceilings, in-place store
columns, allocator and shared-memory budgets, the host syncs each phase
may make, and the lint's scope.  The port reads its own manifest, never
the reference's (``src/repro/analysis/contracts.json``); the budgets
they share are equal, and a test holds them so.
"""
from __future__ import annotations

import json
import os

_DIR = os.path.dirname(os.path.abspath(__file__))
CONTRACTS_PATH = os.path.join(_DIR, "contracts.json")

_REQUIRED_TOP = ("check_config", "trace", "device", "smem", "host_syncs",
                 "repolint")
_REQUIRED_TRACE = ("collectives", "flatness",
                   "max_intermediate_numel_per_table")
PHASES = ("insert", "query", "delete",
          "query_dispatch", "query_scan", "query_return")


def load_contracts(path: str | None = None) -> dict:
    """Load and structurally validate the contract manifest."""
    path = path or CONTRACTS_PATH
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != 1:
        raise ValueError(f"{path}: unsupported contract schema "
                         f"{doc.get('schema')!r}")
    missing = [k for k in _REQUIRED_TOP if k not in doc]
    if missing:
        raise ValueError(f"{path}: missing contract sections {missing}")
    missing = [k for k in _REQUIRED_TRACE if k not in doc["trace"]]
    if missing:
        raise ValueError(f"{path}: missing trace contract keys {missing}")
    for phase in PHASES:
        if phase not in doc["trace"]["collectives"]:
            raise ValueError(f"{path}: no exchange budget for phase "
                             f"{phase!r}")
        names = doc["host_syncs"]["phases"].get(phase)
        if names is None:
            raise ValueError(f"{path}: no host-sync list for phase "
                             f"{phase!r}")
        unknown = [n for n in names if n not in doc["host_syncs"]["allowed"]]
        if unknown:
            raise ValueError(f"{path}: phase {phase!r} names unknown "
                             f"host syncs {unknown}")
    ratio = doc["trace"]["flatness"]["max_ratio"]
    if not (1.0 <= float(ratio) < 2.0):
        raise ValueError(f"{path}: implausible flatness max_ratio {ratio}")
    return doc


def repo_root() -> str:
    """Repository root, assuming the src/repro_torch/analysis layout."""
    return os.path.dirname(os.path.dirname(os.path.dirname(_DIR)))


def flatness_ratio(doc: dict | None = None) -> float:
    """The single flatness ceiling."""
    doc = doc or load_contracts()
    return float(doc["trace"]["flatness"]["max_ratio"])
