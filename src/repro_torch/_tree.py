"""Nested dicts of tensors (the port's param and cache trees)."""

from __future__ import annotations


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict, same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]
