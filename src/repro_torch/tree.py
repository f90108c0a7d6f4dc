"""Trees of tensors: nested dicts, lists and tuples (NamedTuples included)
with tensors, or anything else, at the leaves.  The port keeps parameters,
gradients and optimizer state in such trees, as the reference kept pytrees.
"""
from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf.  Dicts go in
    sorted key order, as ``jax.tree_util`` flattens them."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def leaves_with_path(tree: PyTree, sep: str = "/") -> list:
    """[(path, leaf)], paths joined by ``sep`` (dict keys, field names and
    list indices), in flattening order.  An explicit stack, not a recursive
    closure: a closure that names itself is a reference cycle, which would
    keep every leaf it saw (a step's gradients) alive until the cyclic
    collector ran."""
    out = []
    stack = [(tree, ())]
    while stack:
        node, prefix = stack.pop()
        kids = _children(node)
        if kids is None:
            out.append((sep.join(prefix), node))
            continue
        stack.extend((child, prefix + (key,)) for key, child in reversed(kids))
    return out


def leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over corresponding leaves of trees of one structure; returns a
    tree of that structure (NamedTuples keep their type)."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map(fn, c, *(r[i] for r in rest))
                            for i, c in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, c, *(r[i] for r in rest))
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: PyTree, values) -> PyTree:
    """A tree of ``like``'s structure whose leaves, in flattening order, are
    ``values``.  The recursion is a module function, not a closure that
    names itself, so no reference cycle holds the values (see
    ``leaves_with_path``)."""
    it = iter(values)
    return _build(like, it)


def _build(node, it):
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_build(c, it) for c in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it) for c in node)
    return next(it)
