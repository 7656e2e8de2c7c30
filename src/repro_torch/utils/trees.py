"""Nested-dict parameter trees: the port's counterpart of JAX pytrees."""
from __future__ import annotations


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)

