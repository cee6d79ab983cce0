"""Trees of tensors in jax's leaf order, as the reference's ``jax.tree``
transforms and its checkpoints walk its pytrees.

A tree is dicts (keys visited in sorted order, rebuilt in their own
order), lists, tuples and NamedTuples (``OptState``, ``EFState``);
``None`` is an empty subtree and anything else is a leaf.  A leaf's path
is its keys as jax prints key paths, joined by "/": ``['rows_x']`` for a
dict key, ``[0]`` for a sequence index, ``.mu`` for a NamedTuple field.
The optimizer and the checkpoint both walk trees through this module, so
they agree on the order.
"""
from __future__ import annotations

from typing import Callable


def _children(tree):
    """A node's (key, subtree) pairs in jax's order; None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves_with_paths(tree, prefix=()) -> tuple[list, list]:
    """(paths, leaves) of ``tree`` in jax's order."""
    if tree is None:
        return [], []
    items = _children(tree)
    if items is None:
        return ["/".join(prefix)], [tree]
    paths, vals = [], []
    for name, sub in items:
        p, v = leaves_with_paths(sub, prefix + (name,))
        paths += p
        vals += v
    return paths, vals


def leaves(tree) -> list:
    """The leaves of ``tree`` in jax's order."""
    return leaves_with_paths(tree)[1]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (in jax's order) and the matching
    subtrees of ``rest`` (trees with ``tree``'s structure down to its
    leaves), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _children(tree) is None:
        return fn(tree, *rest)
    out = [tree_map(fn, t, *(r[i] for r in rest))
           for i, t in enumerate(tree)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def unflatten(tree, vals):
    """``tree``'s structure with its leaves replaced by ``vals`` (in
    ``leaves`` order)."""
    it = iter(vals)
    return tree_map(lambda _: next(it), tree)
