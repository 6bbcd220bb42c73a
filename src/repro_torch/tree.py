"""Nested-dict parameter trees: the part of ``jax.tree`` the port needs.

A tree is a dict whose values are trees or leaves (tensors).  Leaves are
visited in sorted key order, as ``jax.tree`` flattens dicts, and named by
their "/"-joined key path.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(flatten(tree[key], f"{prefix}/{key}" if prefix else key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten_like(tree, new_leaves):
    """A tree of ``tree``'s structure holding ``new_leaves`` (in
    :func:`flatten` order)."""
    it = iter(new_leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        return {key: build(node[key]) for key in sorted(node)}
    return build(tree)


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of same-structured ``rest``."""
    others = [leaves(r) for r in rest]
    return unflatten_like(tree, [fn(*args) for args in
                                 zip(leaves(tree), *others)])
