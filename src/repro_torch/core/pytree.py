"""Pytree arithmetic over the port's parameter trees.

A tree is nested dicts, lists and tuples whose leaves are tensors (or
Python scalars); ``None`` is an empty subtree, as in ``jax.tree_util``.
Dict keys are walked in sorted order, as ``jax.tree_util`` walks them,
so the leaf order -- and with it the flat-pack layout of
``kernels/flatpack.py`` -- is the reference's.  Every op broadcasts, so
one definition serves per-device leaves and K-stacked leaves alike (the
polymorphic-shape convention of ``strategies/spec.py``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

_LEAF = object()


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``unflatten(treedef, leaves)`` inverts it."""
    out: List[Any] = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        out.append(t)
        return _LEAF

    return out, walk(tree)


def unflatten(treedef, leaves) -> Any:
    """Rebuild a tree of ``treedef``'s structure from ``leaves``."""
    it = iter(leaves)

    def walk(t):
        if t is _LEAF:
            return next(it)
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return type(t)(walk(x) for x in t)

    return walk(treedef)


def leaves(tree) -> List[Any]:
    """The tree's leaves in reference order."""
    return flatten(tree)[0]


def tmap(fn: Callable, tree, *rest):
    """Leaf-wise ``fn`` over ``tree`` and trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tmap(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tmap(fn, x, *[r[i] for r in rest])
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def add(a, b):
    """Leaf-wise ``a + b`` over matching trees (broadcasting)."""
    return tmap(lambda x, y: x + y, a, b)


def sub(a, b):
    """Leaf-wise ``a - b`` over matching trees (broadcasting)."""
    return tmap(lambda x, y: x - y, a, b)


def scale(a, s):
    """Leaf-wise ``a * s`` for a scalar ``s``."""
    return tmap(lambda x: x * s, a)


def axpy(alpha, x, y):
    """alpha * x + y"""
    return tmap(lambda xi, yi: alpha * xi + yi, x, y)


def zeros_like(a):
    """A tree of zeros with ``a``'s leaf shapes, dtypes and devices."""
    return tmap(torch.zeros_like, a)


def dot(a, b):
    """Full inner product ``<a, b>`` summed over every leaf element."""
    return sum(leaves(tmap(lambda x, y: (x * y).sum(), a, b)))


def norm_sq(a):
    """Squared l2 norm ``||a||^2`` over all leaf elements."""
    return dot(a, a)


def norm(a):
    """l2 norm ``||a||`` over all leaf elements."""
    return torch.sqrt(norm_sq(a))


def mean(trees):
    """Mean of a list of trees (summed in list order, as the reference)."""
    acc = trees[0]
    for t in trees[1:]:
        acc = add(acc, t)
    return scale(acc, 1.0 / len(trees))


def weighted_mean(trees, weights):
    """``sum_i (w_i / sum(w)) * tree_i`` for a list of trees and a
    matching list of (host) scalar weights, accumulated in list order as
    the reference does."""
    total = float(sum(weights))
    acc = scale(trees[0], weights[0] / total)
    for t, w in zip(trees[1:], weights[1:]):
        acc = axpy(w / total, t, acc)
    return acc


def stack(trees):
    """Trees of one structure stacked along a new leading axis."""
    return tmap(lambda *xs: torch.stack(xs), *trees)


def index(tree, i):
    """Row ``i`` of every leaf of a stacked tree."""
    return tmap(lambda x: x[i], tree)
