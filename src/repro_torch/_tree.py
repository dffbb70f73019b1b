"""Nested dicts of tensors (the port's param and cache trees)."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf of a nested dict (and the matching
    leaves of ``rest``, trees of the same structure), same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]
