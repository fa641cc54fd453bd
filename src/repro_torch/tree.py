"""Parameter trees: nested dicts, lists and tuples (NamedTuples included)
with tensors at the leaves, the trees the engine carries (a flat dict for
the MLP; the LM's nested ``blocks`` / ``blocks_unrolled`` tree).

The port's counterpart of the ``jax.tree_util`` calls the JAX engine makes.
``leaves`` walks in JAX's order (dict keys sorted, sequences in order), so
a sum over it adds in the order the JAX package adds; ``tree_map`` keeps
each dict's own key order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree: Tree) -> Iterator[torch.Tensor]:
    """The leaves in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def first_leaf(tree: Tree) -> torch.Tensor:
    return next(leaves(tree))


def unflatten(template: Tree, flat) -> Tree:
    """The tree shaped like ``template`` whose leaves, in ``leaves`` order,
    are ``flat`` (the inverse of ``leaves``); dicts keep their key order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the template holds")
    return out


__all__ = ["Tree", "first_leaf", "leaves", "tree_map", "unflatten"]
