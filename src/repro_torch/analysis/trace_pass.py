"""Trace pass: the port's counterpart of ``repro.analysis.jaxpr_pass``.

PyTorch has no jaxpr, so a phase of the index runs on real tensors under
``OpCounter``, a ``TorchDispatchMode`` (as ``launch/op_cost.py``'s
counter is) that sees every aten op the phase dispatches:

- **ops**: the number of aten ops, the measure of flatness in T.  A
  hand-written kernel's call is one op on either device and the ops
  inside it are not counted (``kernels/watch.py``): on the CPU the
  wrapper runs a plain version whose loops and temporaries the card
  never makes, and the reference's ``pallas_call`` is one equation.
- **the largest intermediate**: of the tensors the phase allocates (an
  op's output with a storage of its own, not a view of an input), the
  one with the most elements (numel, op, shape, dtype), against the
  manifest's per-table ceiling x T.
- **exchanges**: the calls of the index's ``AllToAll`` shim during the
  phase, as ``all_to_all``, held to the exact per-phase budget
  (``check_collectives``, as the reference's).
- **the wire**: the dtype and shape of every payload through the shim.
  64-bit drift is checked there only: the reference's contract is an
  int32/f32 payload, and inside a shard the port uses int64 on purpose
  (argsort indices, ``merge_topk``'s lex keys, uint32 words in int64).
- on the card, **host syncs** and the **allocator's peak**
  (``device_pass.SyncLog``; see there).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import watch


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched while entered, by op, and keeps the
    largest tensor they allocate.  A kernel wrapper marked
    ``watch.opaque`` is one op named ``kernel:<name>`` (set as the
    watcher with ``watch.watching``); ``on_op`` is called after every
    dispatched op, counted or hidden."""

    def __init__(self, on_op: Optional[Callable[[], None]] = None):
        super().__init__()
        self.ops = 0
        self.by_op: Dict[str, int] = {}
        self.top = {"numel": 0, "op": None, "shape": (), "dtype": None}
        self.on_op = on_op
        self._hide = 0

    # -- the watcher's interface (kernels/watch.py) -------------------------
    @contextlib.contextmanager
    def hidden(self):
        self._hide += 1
        try:
            yield
        finally:
            self._hide -= 1

    def kernel_call(self, name: str, out) -> None:
        if self._hide:
            return
        self._count(f"kernel:{name}", [], _tensors(out))

    # -- ops -----------------------------------------------------------------
    def _count(self, name: str, ins, outs) -> None:
        self.ops += 1
        self.by_op[name] = self.by_op.get(name, 0) + 1
        in_keys = {_key(t) for t in ins}
        for t in outs:
            if _key(t) in in_keys or t.numel() <= self.top["numel"]:
                continue
            self.top = {"numel": int(t.numel()), "op": name,
                        "shape": tuple(int(s) for s in t.shape),
                        "dtype": str(t.dtype).replace("torch.", "")}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._hide:
            self._count(str(func._overloadpacket).replace("aten.", ""),
                        _tensors((args, kwargs)), _tensors(out))
        if self.on_op is not None:
            self.on_op()
        return out


class WireTap:
    """Stands in for an index's ``AllToAll`` while a phase runs: every
    exchange goes to the shim (which counts it), and its payload's dtype
    and shape are kept."""

    def __init__(self, shim):
        self.shim = shim
        self.payloads: List[Dict[str, Any]] = []

    def __call__(self, send: torch.Tensor) -> torch.Tensor:
        self.payloads.append({"dtype": str(send.dtype).replace("torch.", ""),
                              "itemsize": send.element_size(),
                              "shape": tuple(int(s) for s in send.shape)})
        return self.shim(send)


@dataclasses.dataclass
class PhaseTrace:
    """What one phase did: its result and the counts the passes read."""
    out: Any
    ops: int
    by_op: Dict[str, int]
    max_intermediate: Dict[str, Any]
    exchanges: int
    wire: List[Dict[str, Any]]
    syncs: Optional[List[Dict[str, Any]]] = None   # on the card
    temp_bytes: Optional[int] = None               # on the card


def trace(idx, fn: Callable[[], Any], sync_log=None) -> PhaseTrace:
    """Run ``fn()`` -- one phase of ``idx`` -- under the op counter and a
    tap on ``idx.a2a``.  ``sync_log`` (a ``device_pass.SyncLog``, on the
    card) also records the phase's host syncs and allocator peak."""
    tap = WireTap(idx.a2a)
    counter = OpCounter(on_op=None if sync_log is None else sync_log.op)
    calls = idx.a2a.calls
    idx.a2a = tap
    try:
        with contextlib.ExitStack() as stack:
            if sync_log is not None:
                stack.enter_context(sync_log)
            stack.enter_context(watch.watching(counter))
            stack.enter_context(counter)
            out = fn()
    finally:
        idx.a2a = tap.shim
    return PhaseTrace(
        out=out, ops=counter.ops, by_op=counter.by_op,
        max_intermediate=counter.top, exchanges=idx.a2a.calls - calls,
        wire=tap.payloads,
        syncs=None if sync_log is None else sync_log.syncs,
        temp_bytes=None if sync_log is None else sync_log.temp_bytes)


def check_collectives(counts: Dict[str, int], budget: Dict[str, int],
                      label: str = "") -> List[str]:
    """Exact-match collective budget check.

    Every collective kind not named in ``budget`` has an implicit budget
    of zero, so a new kind fails closed instead of slipping past a fixed
    allowlist."""
    prefix = f"{label}: " if label else ""
    violations = []
    budget = {k: v for k, v in budget.items() if not k.startswith("_")}
    for kind in sorted(set(budget) | set(counts)):
        want = int(budget.get(kind, 0))
        got = int(counts.get(kind, 0))
        if got != want:
            violations.append(
                f"{prefix}collective budget violated: {kind} x{got}, "
                f"contract allows exactly {want}")
    return violations


def check_flatness(ops_by_tables: Dict[int, int], max_ratio: float,
                   phase: str = "") -> List[str]:
    """The phase is flat in T: max/min op count <= max_ratio."""
    if len(ops_by_tables) < 2:
        return []
    lo, hi = min(ops_by_tables.values()), max(ops_by_tables.values())
    if hi > max_ratio * lo:
        detail = ", ".join(f"T={t}: {n}"
                           for t, n in sorted(ops_by_tables.items()))
        prefix = f"{phase}: " if phase else ""
        return [f"{prefix}ops not flat in n_tables ({detail}); "
                f"max/min = {hi / lo:.3f} > {max_ratio}"]
    return []


def analyze_phase(tr: PhaseTrace, phase: str, n_tables: int,
                  contracts: Dict[str, Any]) -> Dict[str, Any]:
    """Every trace contract of one phase; the report's ``violations`` is
    empty iff they hold."""
    tc = contracts["trace"]
    label = f"{phase}[T={n_tables}]"
    counts = {"all_to_all": tr.exchanges} if tr.exchanges else {}
    violations = check_collectives(counts, tc["collectives"][phase], label)
    ceiling = int(tc["max_intermediate_numel_per_table"][phase]) * n_tables
    top = tr.max_intermediate
    if top["numel"] > ceiling:
        violations.append(
            f"{label}: intermediate {top['op']} {top['shape']} has "
            f"{top['numel']} elements > per-phase ceiling {ceiling} "
            f"(possible O(R*N) materialization)")
    wide = [p for p in tr.wire if p["itemsize"] == 8]
    if tc.get("forbid_wide_dtypes", True) and wide:
        violations.append(
            f"{label}: 64-bit dtype drift on the wire: {wide[0]['dtype']} "
            f"{wide[0]['shape']} (int32/f32 payload contract)")
    return {
        "phase": phase,
        "n_tables": n_tables,
        "collectives": counts,
        "ops": tr.ops,
        "kernels": {k[7:]: n for k, n in tr.by_op.items()
                    if k.startswith("kernel:")},
        "max_intermediate": top,
        "max_intermediate_ceiling": ceiling,
        "wire": tr.wire,
        "violations": violations,
    }

