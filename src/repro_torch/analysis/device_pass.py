"""Device pass: the port's counterpart of ``repro.analysis.hlo_pass``.

- **In place** (donation's counterpart): ``insert`` and ``delete`` write
  the store columns in place.  Each column's storage
  (``untyped_storage().data_ptr()``) must be the same before and after
  the phase while the capacity does not grow.
- **Shared memory** (VMEM's): the bucket kernels' blocks, sized by
  ``scan_plan`` and ``gather_plan`` (``kernels/bucket_search.py``), must
  fit the H100's budget over the whole envelope (every K and L up to the
  manifest's maxima, at ``d_max``); on the card the compiled library's
  ``bucket_search_smem_bytes`` / ``bucket_gather_smem_bytes`` must equal
  the plans' numbers.
- **On the card only** (``SyncLog``): the CUDA allocator's peak above a
  phase's inputs and outputs, per shard, against the reference's temp
  budget; and each phase's host syncs, counted in torch's sync-debug
  "warn" mode, each attributed to the function of the port that made
  it, against the manifest's named allowance.
- The reference's HLO collective cross-check has no counterpart: one
  process has one exchange counter, the shim the trace pass reads.
"""
from __future__ import annotations

import ast
import collections
import functools
import gc
import os
import sys
import warnings
from typing import Any, Dict, List, Optional

import torch

_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.dirname(_PORT)
# torch's message for each synchronizing call in sync-debug "warn" mode;
# its first set_sync_debug_mode also warns once that the mode is a
# prototype ("... synchronizing operations"), which is no sync
SYNC_WARNING = "called a synchronizing CUDA operation"
# frames that are the gate's own, not the code it measures
_SKIP = (os.path.join(_PORT, "analysis") + os.sep,
         os.path.join(_PORT, "kernels", "watch.py"))


# ---------------------------------------------------------------------------
# In place
# ---------------------------------------------------------------------------

def column_storages(store, columns) -> Dict[str, int]:
    """Each named store column's storage address."""
    return {c: getattr(store, c).untyped_storage().data_ptr()
            for c in columns}


def in_place_report(before: Dict[str, int], after: Dict[str, int],
                    cap_before: int, cap_after: int, phase: str,
                    n_tables: int,
                    contracts: Dict[str, Any]) -> Dict[str, Any]:
    """Did ``phase`` write the manifest's columns in place?"""
    cols = contracts["device"]["in_place"].get(phase, [])
    label = f"{phase}[T={n_tables}]"
    violations = []
    if cap_after != cap_before:
        violations.append(
            f"{label}: the store grew from {cap_before} to {cap_after} "
            f"slots a shard; the check reserves room, so every column "
            f"was copied")
    moved = [c for c in cols if before[c] != after[c]]
    if moved:
        violations.append(
            f"{label}: store column(s) {moved} not written in place (the "
            f"storage moved): the donation contract")
    return {"phase": phase, "columns": cols, "moved": moved,
            "capacity": [cap_before, cap_after], "violations": violations}


# ---------------------------------------------------------------------------
# Shared memory
# ---------------------------------------------------------------------------

def smem_report(contracts: Dict[str, Any], lib=None) -> Dict[str, Any]:
    """The bucket kernels' shared memory over the envelope: every K in
    [1, k_neighbors_max] and L in [1, L_max] at d_max within the budget;
    with ``lib`` (the compiled library, on the card) the plans equal to
    its own sizes."""
    from repro_torch.kernels import bucket_search as kbs
    sc = contracts["smem"]
    budget = int(sc["budget_bytes"])
    d, L_max = int(sc["d_max"]), int(sc["L_max"])
    K_max = int(sc["k_neighbors_max"])
    violations: List[str] = []
    worst_scan, worst_gather, mismatches = 0, 0, []
    for K in range(1, K_max + 1):
        try:
            gather = kbs.gather_plan(K)
        except ValueError as exc:
            violations.append(f"smem: gather_plan(K={K}) refused: {exc}")
            continue
        worst_gather = max(worst_gather, gather)
        if lib is not None and lib.bucket_gather_smem_bytes(K) != gather:
            mismatches.append(("bucket_gather", K, None, gather,
                               lib.bucket_gather_smem_bytes(K)))
        for L in range(1, L_max + 1):
            try:
                plan = kbs.scan_plan(1, kbs.TILE_R, kbs.TILE_R, d, L, K)
            except ValueError as exc:
                violations.append(f"smem: scan_plan(K={K}, L={L}) "
                                  f"refused: {exc}")
                continue
            worst_scan = max(worst_scan, plan.smem_bytes)
            if lib is not None:
                got = lib.bucket_search_smem_bytes(
                    K, plan.table_slots, int(plan.table_in_smem))
                if got != plan.smem_bytes:
                    mismatches.append(("bucket_search", K, L,
                                       plan.smem_bytes, got))
    for name, got in (("bucket_search", worst_scan),
                      ("bucket_gather", worst_gather)):
        if got > budget:
            violations.append(
                f"smem: {name} blocks take {got} bytes at d={d}, "
                f"L<={L_max}, K<={K_max} > budget {budget}")
    for name, K, L, plan_bytes, lib_bytes in mismatches[:4]:
        violations.append(
            f"smem: {name} at K={K}, L={L}: the plan says {plan_bytes} "
            f"bytes, the compiled library {lib_bytes}")
    top = kbs.scan_plan(1, kbs.TILE_R, kbs.TILE_R, d, L_max, K_max)
    return {"budget_bytes": budget,
            "envelope": {"d": d, "L": L_max, "K": K_max},
            "bucket_search_bytes": top.smem_bytes,
            "bucket_search_table_in_smem": top.table_in_smem,
            "bucket_gather_bytes": kbs.gather_plan(K_max),
            "largest": {"bucket_search": worst_scan,
                        "bucket_gather": worst_gather},
            "library_checked": lib is not None,
            "library_mismatches": len(mismatches),
            "violations": violations}


# ---------------------------------------------------------------------------
# Host syncs and the allocator's peak (on the card)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _functions(path: str) -> List[tuple]:
    """(first line, last line, qualname) of every function in a file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []

    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = scope + [child.name]
                if not isinstance(child, ast.ClassDef):
                    out.append((child.lineno, child.end_lineno,
                                ".".join(name)))
                walk(child, name)
            else:
                walk(child, scope)
    walk(tree, [])
    return out


def _function_at(path: str, line: int) -> str:
    """The outermost function of ``path`` holding ``line`` (a method is
    ``Class.method``; a function nested in it counts as the method)."""
    for lo, hi, name in _functions(path):
        if lo <= line <= hi:
            return name
    return "<module>"


def _port_frame() -> Optional[tuple]:
    """(file, line, qualname) of the innermost frame of the port outside
    this gate, or None."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PORT) and not path.startswith(_SKIP):
            return (path, f.f_lineno,
                    f.f_code.co_qualname.split(".<locals>.")[0])
        f = f.f_back
    return None


class SyncLog:
    """While entered (on the card): every synchronizing CUDA call torch
    reports in sync-debug "warn" mode, with the port's file, line and
    function that made it (``syncs``), and, with ``peak`` (the default),
    the allocator's peak above the larger of the memory held on entry and
    on exit (``temp_bytes``).  That peak RESETS the allocator's peak
    statistics on entry: a caller measuring its own peak across a SyncLog
    reads it before, or passes ``peak=False`` (``temp_bytes`` then stays
    None).  A dispatch counter calls ``op()`` after each op it sees, so
    that a sync made inside an op is attributed while the op's caller is
    on the stack; one made outside any op (a host-to-device copy in
    ``torch.as_tensor``) carries the caller's line itself."""

    def __init__(self, peak: bool = True):
        self.peak = peak
        self.syncs: List[Dict[str, Any]] = []
        self.temp_bytes: Optional[int] = None

    def __enter__(self):
        # a finalizer of earlier work must not run (and sync) inside
        gc.collect()
        torch.cuda.synchronize()
        self._base = torch.cuda.memory_allocated()
        if self.peak:
            torch.cuda.reset_peak_memory_stats()
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        self._seen = 0
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def op(self) -> None:
        new = self._caught[self._seen:]
        self._seen = len(self._caught)
        for w in new:
            if SYNC_WARNING not in str(w.message):
                continue
            where = None
            if w.filename.startswith(_PORT) and not w.filename.startswith(
                    _SKIP):
                where = (w.filename, w.lineno,
                         _function_at(w.filename, w.lineno))
            else:
                where = _port_frame()
            path, line, fn = where or (w.filename, w.lineno, "?")
            rel = (os.path.relpath(path, _SRC) if path.startswith(_SRC)
                   else os.path.basename(path))
            self.syncs.append({
                "where": f"{rel}:{line}",
                "function": fn,
                "warned_at": f"{os.path.basename(w.filename)}:{w.lineno}"})

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self.op()
        self._catch.__exit__(*exc)
        torch.cuda.synchronize()
        if not self.peak:
            return False
        peak = torch.cuda.max_memory_allocated()
        self.temp_bytes = max(0, peak - max(self._base,
                                            torch.cuda.memory_allocated()))
        return False


def sync_report(syncs: List[Dict[str, Any]], phase: str, n_tables: int,
                contracts: Dict[str, Any]) -> Dict[str, Any]:
    """The phase's host syncs against the manifest: exactly the named
    allowances of the phase, by function."""
    hs = contracts["host_syncs"]
    names = hs["phases"][phase]
    want = collections.Counter(hs["allowed"][n]["function"] for n in names)
    got = collections.Counter(s["function"] for s in syncs)
    label = f"{phase}[T={n_tables}]"
    violations = []
    if got != want:
        where = collections.Counter(f"{s['function']} at {s['where']}"
                                    for s in syncs)
        violations.append(
            f"{label}: {len(syncs)} host syncs on the card "
            f"({dict(where)}); the manifest allows {len(names)}: "
            f"{names or 'none'}")
    return {"phase": phase, "n_tables": n_tables, "count": len(syncs),
            "allowed": names, "syncs": syncs, "violations": violations}


def memory_report(temp_bytes: int, n_shards: int, phase: str,
                  contracts: Dict[str, Any]) -> Dict[str, Any]:
    """The allocator's peak above a phase's inputs and outputs, per
    shard, against the reference's per-device temp budget."""
    ceiling = contracts["device"]["temp_bytes_ceiling"].get(phase)
    per_shard = temp_bytes / n_shards
    rep = {"phase": phase, "temp_bytes": temp_bytes,
           "temp_bytes_per_shard": per_shard,
           "temp_bytes_ceiling": ceiling, "violations": []}
    if ceiling is not None and per_shard > int(ceiling):
        rep["violations"].append(
            f"{phase}: the allocator peaked {temp_bytes} bytes above the "
            f"phase's inputs and outputs, {per_shard:.0f} a shard > "
            f"budget {int(ceiling)} (possible O(R*N) scratch)")
    return rep
