"""Nested-dict parameter trees: the port's counterpart of JAX pytrees."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise to one tree, or to several of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _leaf: next(it), tree)
