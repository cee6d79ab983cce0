"""AST lint of the port: the reference's four rules over the port's scope.

The rules of ``repro.analysis.repolint``, configured by the ``repolint``
section of the port's ``contracts.json``:

- **host-sync**: no host sync inside a hot scope -- any function of
  ``src/repro_torch/kernels/``, or the index's device work
  (``DistributedLSHIndex._insert``, ``_delete``, ``_dispatch``,
  ``_scan``, ``_return``).  A sync is a call of ``np.asarray`` /
  ``np.array`` / ``torch.nonzero`` / ``torch.cuda.synchronize``, a method
  call ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
  ``.nonzero()`` / ``.synchronize()``, or ``int`` / ``float`` / ``bool``
  of a method call on a tensor expression (``int(x.sum().max())``: its
  receiver is not a name bound to a host value, such as the result of
  ``.numpy()`` or of an ``np`` call).  ``.cpu().numpy()`` is one sync.
  A Python scalar written through a tensor index (``a[idx] = True``)
  counts too: index_put_ copies it to the card first, synchronously.
  A known sync is allowed by name: a ``# host-sync: <name>`` comment on
  its statement, or on the comment lines right above it, names an entry
  of ``host_syncs.allowed`` whose ``function`` is the function it sits
  in.  Every entry with ``"lint": true`` must be used (``scan``).
- **deprecated-shim**: no ``best_dist`` / ``best_gid`` / ``table_params``
  / ``table_keys`` access outside the files that define the shims.
- **kw-only-kernel-api**: ``QueryBatch`` / ``StoreView`` and the
  ``bucket_search*`` entry points take keyword arguments only.
- **store-mutation**: ``StoreState`` construction and store-column
  assignment only inside ``core/index.py`` / ``core/store_layout.py``.

Pure stdlib (``ast``): it needs no device and imports no torch.
"""
from __future__ import annotations

import ast
import dataclasses
import glob
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Set

_MARKER = re.compile(r"#\s*host-sync:\s*([a-z0-9][a-z0-9-]*)")
# receivers whose method calls are host values
_HOST_ROOTS = {"np", "numpy", "math"}
# calls whose result is a host value
_HOST_CALLS = {"int", "float", "bool", "len", "max", "min", "sum", "abs",
               "round", "range", "str", "tuple", "list"}
_HOST_METHODS = {"numpy", "tolist", "item"}


@dataclasses.dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    rule: str
    msg: str

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


def _dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root(node: ast.AST) -> Optional[str]:
    """The name an attribute / subscript / method-call chain hangs from."""
    while True:
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


def _tensor_indexed(node: ast.AST) -> bool:
    """``a[i, j]`` with an index that is neither a slice nor a constant
    (an advanced, tensor index)."""
    if not isinstance(node, ast.Subscript):
        return False
    parts = node.slice.elts if isinstance(node.slice, ast.Tuple) else [
        node.slice]
    return any(not isinstance(p, (ast.Slice, ast.Constant)) for p in parts)


def _is_scalar(node: ast.AST) -> bool:
    """A Python number or bool literal (signed too)."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) and isinstance(
        node.value, (bool, int, float))


def _is_storeish(node: ast.AST) -> bool:
    """Heuristic: does this expression look like a StoreState value?"""
    if isinstance(node, ast.Name):
        return node.id in ("st", "store") or "store" in node.id.lower()
    if isinstance(node, ast.Attribute):
        return "store" in node.attr.lower()
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str, source: str, cfg: Dict[str, Any],
                 allowed: Dict[str, Dict[str, Any]]):
        self.relpath = relpath.replace(os.sep, "/")
        self.lines = source.splitlines()
        self.cfg = cfg
        self.allowed = allowed
        self.violations: List[LintViolation] = []
        self.used: Set[str] = set()
        self._scope: List[str] = []        # class and function names
        self._funcs = 0                    # functions entered
        self._host: List[Set[str]] = [set()]
        self._stmt: Optional[ast.stmt] = None
        self._hot_module = any(
            self.relpath.startswith(m.rstrip("/") + "/") or self.relpath == m
            for m in cfg.get("hot_modules", ()))
        self._hot_fns = set(cfg.get("hot_functions", {}).get(self.relpath,
                                                              ()))

    # -- helpers ----------------------------------------------------------
    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        self.violations.append(
            LintViolation(self.relpath, getattr(node, "lineno", 0), rule, msg))

    def _allowed(self, key: str) -> bool:
        return self.relpath in set(self.cfg.get(key, ()))

    def _qualname(self) -> str:
        return ".".join(self._scope)

    def _in_hot_scope(self) -> bool:
        if not self._funcs:
            return False  # module or class level: setup, not device work
        if self._hot_module:
            return True
        return any(".".join(self._scope[:i]) in self._hot_fns
                   for i in range(1, len(self._scope) + 1))

    def _hot_function(self) -> str:
        """The hot function the current node sits in (outermost match)."""
        for i in range(1, len(self._scope) + 1):
            if ".".join(self._scope[:i]) in self._hot_fns:
                return ".".join(self._scope[:i])
        return self._qualname()

    def _markers(self) -> List[str]:
        """Names of the ``# host-sync:`` comments on the current
        statement's lines and on the comment lines right above it."""
        stmt = self._stmt
        if stmt is None:
            return []
        lo, hi = stmt.lineno, getattr(stmt, "end_lineno", stmt.lineno)
        text = self.lines[lo - 1:hi]
        i = lo - 2
        while i >= 0 and self.lines[i].strip().startswith("#"):
            text.append(self.lines[i])
            i -= 1
        return [m.group(1) for line in text for m in _MARKER.finditer(line)]

    def _is_host(self, node: ast.AST) -> bool:
        """Is this expression's value on the host (not a tensor)?"""
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Call):
            name = _dotted_name(node.func)
            if name in _HOST_CALLS:
                return True
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_METHODS):
                return True
        root = _root(node)
        return root is not None and (root in _HOST_ROOTS
                                     or root in self._host[-1])

    def _sync_kind(self, node: ast.Call) -> Optional[str]:
        """What makes this call a host sync, or None."""
        name = _dotted_name(node.func)
        if name in set(self.cfg.get("host_sync_calls", ())):
            return f"{name}()"
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in set(self.cfg.get("host_sync_methods",
                                                       ()))):
            return f".{node.func.attr}()"
        if (name in set(self.cfg.get("host_sync_casts", ()))
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Call)
                and isinstance(node.args[0].func, ast.Attribute)
                and self._sync_kind(node.args[0]) is None
                and not self._is_host(node.args[0])):
            return f"{name}() of a tensor"
        return None

    def _check_sync(self, node: ast.Call) -> None:
        kind = self._sync_kind(node)
        if kind is None:
            return
        # .cpu().numpy(): the inner call is the one copy
        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Call)
                and self._sync_kind(node.func.value) is not None):
            return
        self._flag_sync(node, kind)

    def _flag_sync(self, node: ast.AST, kind: str) -> None:
        where = self._hot_function()
        for name in self._markers():
            entry = self.allowed.get(name)
            if entry is None:
                self._flag(node, "host-sync",
                           f"{kind} is marked '{name}', which no entry of "
                           f"host_syncs.allowed names")
                return
            if entry.get("function") == where:
                self.used.add(name)
                return
            self._flag(node, "host-sync",
                       f"{kind} is marked '{name}', allowed in "
                       f"{entry.get('function')} only (scope {where})")
            return
        self._flag(node, "host-sync",
                   f"{kind} forces a device->host sync inside a hot path "
                   f"(scope {where})")

    # -- scope tracking ---------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._scope.append(node.name)
        self._funcs += 1
        self._host.append(set())
        self.generic_visit(node)
        self._host.pop()
        self._funcs -= 1
        self._scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit(self, node: ast.AST) -> Any:
        if isinstance(node, ast.stmt):
            outer, self._stmt = self._stmt, node
            try:
                return super().visit(node)
            finally:
                self._stmt = outer
        return super().visit(node)

    # -- rules ------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted_name(node.func)
        last = name.rsplit(".", 1)[-1] if name else None

        if self._in_hot_scope():
            self._check_sync(node)

        if (last in set(self.cfg.get("kw_only_calls", ()))
                and node.args and not self._allowed("kw_only_allow")):
            self._flag(node, "kw-only-kernel-api",
                       f"{last}() takes keyword arguments only; "
                       f"{len(node.args)} positional argument(s) passed")

        if last == "StoreState" and not self._allowed("store_mutation_allow"):
            self._flag(node, "store-mutation",
                       "StoreState may only be constructed in "
                       "core/index.py or core/store_layout.py "
                       "(CSR invariants live there)")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (node.attr in set(self.cfg.get("deprecated_attrs", ()))
                and not self._allowed("deprecated_allow")):
            self._flag(node, "deprecated-shim",
                       f".{node.attr} is a deprecated compat shim "
                       f"(use the stacked/top-K API)")
        self.generic_visit(node)

    def _check_store_assign(self, target: ast.AST) -> None:
        if (isinstance(target, ast.Attribute)
                and target.attr in set(self.cfg.get("store_columns", ()))
                and _is_storeish(target.value)
                and not self._allowed("store_mutation_allow")):
            self._flag(target, "store-mutation",
                       f"direct mutation of store column .{target.attr} "
                       f"outside core/index.py / core/store_layout.py")

    def _bind(self, target: ast.AST, host: bool) -> None:
        if isinstance(target, ast.Name):
            (self._host[-1].add if host else self._host[-1].discard)(
                target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, host)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                self._check_store_assign(el)
            if (self._in_hot_scope() and _tensor_indexed(t)
                    and _is_scalar(node.value)):
                self._flag_sync(t, "a Python scalar written through a "
                                   "tensor index (copied to the card first)")
        self.generic_visit(node)
        host = self._is_host(node.value)
        for t in node.targets:
            self._bind(t, host)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store_assign(node.target)
        self.generic_visit(node)


def lint_source(source: str, relpath: str, cfg: Dict[str, Any],
                allowed: Optional[Dict[str, Dict[str, Any]]] = None,
                used: Optional[Set[str]] = None) -> List[LintViolation]:
    """Lint one file's source text (unit-testable entry point).
    ``allowed`` is the manifest's ``host_syncs.allowed``; the names of
    the entries the file uses are added to ``used``."""
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as exc:
        return [LintViolation(relpath, exc.lineno or 0, "syntax",
                              f"unparseable: {exc.msg}")]
    linter = _Linter(relpath, source, cfg, allowed or {})
    linter.visit(tree)
    if used is not None:
        used.update(linter.used)
    return linter.violations


def scan_files(paths: Iterable[str], cfg: Dict[str, Any],
               rel_root: Optional[str] = None,
               allowed: Optional[Dict[str, Dict[str, Any]]] = None,
               used: Optional[Set[str]] = None) -> List[LintViolation]:
    """Lint explicit files; paths reported relative to ``rel_root``."""
    out: List[LintViolation] = []
    for path in paths:
        rel = os.path.relpath(path, rel_root) if rel_root else path
        with open(path) as f:
            out.extend(lint_source(f.read(), rel, cfg, allowed, used))
    return out


def files(repo_root: str, cfg: Dict[str, Any]) -> List[str]:
    """The manifest's ``scan`` globs under ``repo_root``, sorted."""
    found = set()
    for pattern in cfg.get("scan", ()):
        found.update(p for p in glob.glob(os.path.join(repo_root, pattern),
                                          recursive=True)
                     if p.endswith(".py") and "__pycache__" not in p)
    return sorted(found)


def scan(repo_root: str, contracts: Dict[str, Any]) -> Dict[str, Any]:
    """Lint every file of the scan globs, and report the allowances of
    ``host_syncs.allowed`` marked ``lint`` that no marker used."""
    cfg = contracts["repolint"]
    allowed = {k: v for k, v in contracts["host_syncs"]["allowed"].items()
               if not k.startswith("_")}
    paths = files(repo_root, cfg)
    used: Set[str] = set()
    violations = scan_files(paths, cfg, rel_root=repo_root,
                            allowed=allowed, used=used)
    for name, entry in sorted(allowed.items()):
        if entry.get("lint") and name not in used:
            violations.append(LintViolation(
                "src/repro_torch/analysis/contracts.json", 0, "host-sync",
                f"allowance '{name}' ({entry.get('function')}) marks no "
                f"sync of the code: stale"))
    return {"files_scanned": len(paths),
            "allowances_used": sorted(used),
            "violations": [v.as_dict() for v in violations]}
