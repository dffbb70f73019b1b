"""Nested dicts of tensors (the port's param and cache trees).

A NamedTuple (the optimizer's ``OptState``) is a node too, its fields in
order, as JAX flattens one; any other tuple is a leaf."""

from __future__ import annotations


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf of a nested dict (and the matching
    leaves of ``rest``, trees of the same structure), same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if is_namedtuple(tree):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
