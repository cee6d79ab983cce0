"""A dispatch-level cost counter over meta tensors: the dry run's FLOPs,
bytes and peak memory.  It stands for the reference's
``repro.launch.hlo_cost`` (``analyze``), which reads them off compiled
HLO; PyTorch has no HLO, so a step runs on the meta device (shapes and
dtypes, no data) under ``Counter``, a ``TorchDispatchMode`` that sees
every aten op as it is dispatched:

* FLOPs: ``torch.utils.flop_counter``'s formulas (the products and
  convolutions; an elementwise op counts none).  A hand-written kernel's
  wrapper takes the card's route on meta tensors: it calls its ``plan``
  and reports its launch here (``kernel``) with the (FLOPs, bytes) of its
  cost function in ``launch/hlo_analysis.py``, so the dry run counts the
  kernels that run on the card, never their plain versions.
* bytes: each op's tensor inputs read once and its outputs written once
  (a view, an alias or an empty allocation moves none; an indexed write
  only the rows it writes).  Every intermediate goes through memory,
  unfused: an upper bound on the card's HBM traffic, where XLA's count is
  of its fused kernels.
* peak: the live bytes of meta storage, each storage counted from the op
  that makes it until it is freed (a weakref finalizer on the storage,
  which PyTorch keeps alive as long as any tensor -- an autograd saved
  tensor too -- holds it), at the size the CUDA caching allocator gives
  it (whole blocks of 512 bytes); ``hold`` adds storages made before.
* trip counts, as ``hlo_cost`` scales a while loop's body by its trip
  count: a Python loop whose trip count is a length (``models/ssm.py``'s
  stateful recurrence, one step a token; ``launch/steps.py``'s
  microbatches) runs its body once on meta under ``trips(n)``, which
  counts the body's FLOPs, bytes, launches and what it adds to the live
  bytes n times, and its peak as the n-th iteration's.  A loop entered with a
  trip count that is not a known int is counted once and tallied in
  ``unknown_trip_loops``, the reference's name; every other loop runs
  unrolled on meta and is counted exactly.

``aten::bincount`` has no meta kernel (its length depends on the data);
the counter gives it one, of length ``minlength`` -- right wherever
every value is below it, as ``models/moe.py``'s expert ids are below E.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
BLOCK = 512      # the CUDA caching allocator's allocation granule
# ops that only write their first argument: it is not read
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
# in-place indexed writes: the first argument's indexed rows are written,
# the rest of it untouched
_INDEXED = {aten.index_copy_, aten.index_put_, aten.index_fill_,
            aten.scatter_, aten.index_add_}
_PRODUCTS = {aten.mm, aten.bmm}
# allocations that write nothing
_EMPTY = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}
_ACTIVE: list = []


def alloc_bytes(nbytes: int) -> int:
    """The caching allocator's block for a request of ``nbytes``."""
    return -(-nbytes // BLOCK) * BLOCK


def _traffic(t: torch.Tensor) -> int:
    """Bytes of t's distinct elements (a broadcast dimension once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bincount_meta(x, weights=None, minlength=0):
    if minlength <= 0:
        raise NotImplementedError(
            "aten::bincount on meta needs minlength: its length otherwise "
            "depends on the data")
    dtype = torch.int64 if weights is None else (
        torch.float64 if weights.dtype != torch.float32 else weights.dtype)
    return torch.empty((minlength,), dtype=dtype, device="meta")


class _Frame:
    """An open ``trips(n)``: live bytes at its entry, the highest live
    bytes inside it, and the storages made inside it."""

    def __init__(self, n: int, live: int):
        self.n, self.enter, self.top, self.made = n, live, live, set()


class Counter(TorchDispatchMode):
    """FLOPs, bytes, kernel launches and live bytes of the ops dispatched
    while it is entered (see the module's docstring).  ``trip_aware=False``
    makes ``trips`` run every iteration: the unrolled count that the
    trip-aware one must equal."""

    def __init__(self, trip_aware: bool = True):
        super().__init__()
        self.trip_aware = trip_aware
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: dict = {}
        self.live = 0
        self.peak = 0
        self.unknown_trip_loops = 0
        self._sizes: dict = {}       # storage -> bytes counted live
        self._finalizers: dict = {}
        self._frames: list = []
        self._scale = 1

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        for f in self._finalizers.values():
            f.detach()
        self._finalizers.clear()
        return super().__exit__(*exc)

    # -- live bytes ----------------------------------------------------------

    def _bump(self, live: int) -> None:
        self.peak = max(self.peak, live)
        for f in self._frames:
            f.top = max(f.top, live)

    def _alloc(self, storage, key: int) -> None:
        size = alloc_bytes(storage.nbytes())
        self._sizes[key] = size
        self.live += size
        self._finalizers[key] = weakref.finalize(storage, self._free, key)
        if self._frames:
            self._frames[-1].made.add(key)
        self._bump(self.live)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)
        self._finalizers.pop(key, None)

    def hold(self, tree) -> int:
        """Count the meta storages of ``tree``'s tensors (made before the
        counter) as live from now; returns the live bytes."""
        for t in _tensors(tree):
            if t.is_meta and _key(t) not in self._sizes:
                self._alloc(t.untyped_storage(), _key(t))
        return self.live

    # -- ops -----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten.bincount.default and args[0].is_meta:
            out = _bincount_meta(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func._overloadpacket
        if packet in flop_registry:
            # a product's float32-output overload passes its dtype third,
            # where the formula takes nothing
            fargs = args[:2] if packet in _PRODUCTS else args
            self.flops += self._scale * flop_registry[packet](
                *fargs, **kwargs, out_val=out)
        in_keys = {_key(t) for t in ins if t.is_meta}
        new = [t for t in outs if t.is_meta and _key(t) not in in_keys]
        if packet not in _EMPTY and (new or func._schema.is_mutable):
            self.bytes += self._scale * _op_bytes(packet, ins, outs)
        for t in new:
            if _key(t) not in self._sizes:
                self._alloc(t.untyped_storage(), _key(t))
        return out

    def kernel(self, name: str, design: str, flops: float,
               nbytes: float) -> None:
        rec = self.kernels.setdefault(
            name, {"launches": 0, "designs": {}, "flops": 0.0, "bytes": 0.0})
        rec["launches"] += self._scale
        rec["designs"][design] = rec["designs"].get(design, 0) + self._scale
        rec["flops"] += self._scale * flops
        rec["bytes"] += self._scale * nbytes
        self.flops += self._scale * flops
        self.bytes += self._scale * nbytes

    # -- trip counts ---------------------------------------------------------

    def _open(self, n: int) -> None:
        self._frames.append(_Frame(n, self.live))
        self._scale *= n

    def _close(self) -> None:
        """Count the other n - 1 iterations of the body just run: each
        adds what one added to the live bytes (the outputs a loop keeps,
        as a list of per-step results; nothing where each iteration
        replaces what the last made, as an accumulated sum), so the n-th
        starts that much higher.  The kept storages carry the added
        bytes, so that freeing them after the loop frees all of it."""
        f = self._frames.pop()
        self._scale //= f.n
        kept = sorted((k for k in f.made if k in self._sizes),
                      key=self._sizes.get)
        grown = max(self.live - f.enter, 0)
        extra = (f.n - 1) * grown
        self._bump(f.top + extra)
        made = sum(self._sizes[k] for k in kept)
        left = extra
        for i, k in enumerate(kept):
            share = left if i == len(kept) - 1 else (
                extra * self._sizes[k] // made)
            self._sizes[k] += share
            left -= share
        self.live += extra
        if self._frames:
            self._frames[-1].made.update(kept)
        self._bump(self.live)


def _op_bytes(packet, ins, outs) -> int:
    """Bytes one op reads and writes: its inputs and outputs once each;
    a write-only op does not read its destination, an indexed write
    touches the rows of its source only."""
    if packet in _WRITE_ONLY:
        return sum(_traffic(t) for t in ins[1:]) + _traffic(ins[0])
    if packet in _INDEXED:
        rest = ins[1:]
        written = _traffic(rest[-1]) if rest else 0
        return sum(_traffic(t) for t in rest) + written
    return sum(_traffic(t) for t in ins) + sum(_traffic(t) for t in outs)


def active() -> Counter | None:
    """The innermost entered ``Counter``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def kernel(name: str, design: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's launch on meta tensors (its wrapper's card
    route, which launches nothing): counted by the active counter, if
    any."""
    c = active()
    if c is not None:
        c.kernel(name, design, flops, nbytes)


@contextlib.contextmanager
def trips(n, like: torch.Tensor):
    """The iterations a loop of ``n`` trips over tensors like ``like``
    should run: ``n``, but on meta tensors under a trip-aware counter one,
    counted n times (its peak as the n-th iteration's).  The loop's body
    must do the same work at every iteration."""
    c = active()
    if c is None or not like.is_meta or not c.trip_aware:
        yield n
        return
    if not isinstance(n, int) or n < 0:
        c.unknown_trip_loops += 1
        yield 1
        return
    if n <= 1:
        yield n
        return
    c._open(n)
    try:
        yield 1
    finally:
        c._close()
