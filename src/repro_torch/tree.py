"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

A tree is a dict (or list/tuple) of trees or a leaf tensor; trees built by
the same code share their key order, so ``tree_leaves`` of two such trees
line up leaf for leaf."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in key order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
