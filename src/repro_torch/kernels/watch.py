"""A hand-written kernel's call as one op, for a dispatch counter.

The contract gate's trace pass (``analysis/trace_pass.py``) counts the
aten ops that a phase of the index dispatches.  On the card a kernel
wrapper is one launch; on CPU tensors it runs the kernel's plain version
(``ref.py``), whose loops and (rows, chunk) temporaries the card never
makes.  ``opaque`` marks a wrapper: while a watcher is set
(``watching``), the wrapper's call reaches the watcher as one op with
its outputs (``watcher.kernel_call(name, out)``), and the ops inside it
-- the launch's own allocations on the card, the plain version on the
CPU -- are hidden from it (``with watcher.hidden():``).  With no watcher
the wrapper runs as it is.

``launch/op_cost.py`` has a second hook, ``op_cost.kernel``, and the two
stay apart because they tell a counter different things.  The flash and
SSD wrappers call that one on meta tensors, where nothing launches, with
the launch's FLOPs and bytes, while the dry run's counter goes on seeing
the wrapper's own output allocations (they are the step's live bytes).
This one is on the bucket and hash wrappers: it runs the real call,
hides every op inside it, and reports the call as one op with its
outputs.
The two serve disjoint kernels: the dry run's model steps reach no
bucket or hash kernel, the index's phases no flash or SSD kernel.
"""
from __future__ import annotations

import contextlib
import functools

_WATCHERS: list = []


@contextlib.contextmanager
def watching(watcher):
    """Report every ``opaque`` call to ``watcher`` while entered."""
    _WATCHERS.append(watcher)
    try:
        yield watcher
    finally:
        _WATCHERS.remove(watcher)


def opaque(name: str):
    """Decorator: the wrapped kernel wrapper is one op named ``name`` to
    the innermost watcher."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _WATCHERS:
                return fn(*args, **kwargs)
            watcher = _WATCHERS[-1]
            with watcher.hidden():
                out = fn(*args, **kwargs)
            watcher.kernel_call(name, out)
            return out
        return call
    return wrap
