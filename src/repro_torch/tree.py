"""Walks over trees of dictionaries and lists, the shape the port's params,
gradients and optimiser moments take."""
from __future__ import annotations

from typing import Any, List


def tree_map(fn, tree: Any):
    """``fn`` over the leaves of a tree of dictionaries and lists (tuples
    become lists), in its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any, *, sort_keys: bool = False) -> List:
    """The leaves of a tree of dictionaries and lists, in its order; with
    ``sort_keys`` in ``jax.tree.flatten``'s (dictionary keys sorted)."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort_keys else tree
        return [t for k in keys for t in tree_leaves(tree[k],
                                                      sort_keys=sort_keys)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v, sort_keys=sort_keys)]
    return [tree]
