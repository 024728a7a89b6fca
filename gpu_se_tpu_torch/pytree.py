"""Flatten and rebuild nested tuples, lists and dicts of tensors.

The resample router takes any such tree of ``(n, ...)`` tensors, as the
reference takes a JAX pytree. Leaves come in the reference's order:
sequences in order, dicts by sorted key (as ``jax.tree_util`` does), so
the "first leaf" that picks a route is the reference's.
"""
from __future__ import annotations

from typing import Callable

import torch


def tree_flatten(tree):
    """``(leaves, treedef)``; :func:`tree_unflatten` inverts it."""
    leaves = []

    def spec(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return None
        if isinstance(t, dict):
            keys = sorted(t)
            return (dict, keys, [spec(t[k]) for k in keys])
        if isinstance(t, (tuple, list)):
            return (type(t), None, [spec(c) for c in t])
        raise TypeError(f"not a tensor, tuple, list or dict: {type(t)}")

    return leaves, spec(tree)


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        built = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, built))
        if hasattr(kind, "_fields"):          # a namedtuple
            return kind(*built)
        return kind(built)

    return build(treedef)


def tree_map(fn: Callable, tree):
    """The tree with ``fn`` applied to every leaf."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(leaf) for leaf in leaves])
