"""Nested-dict trees of tensors, the port's stand-in for ``jax.tree_util``
over the parameter tree (a :class:`ParamTree` is taken as its ``tree()``).
Leaves come in ``jax.tree_util``'s order for dicts: keys sorted, depth
first, which is the order of the reference's checkpoints."""

from __future__ import annotations


def as_tree(tree):
    """The nested dict of a :class:`ParamTree` (or the tree itself)."""
    return tree.tree() if hasattr(tree, "tree") else tree


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, depth first."""
    tree = as_tree(tree)
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in tree_leaves(tree[k])]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure; the
    result's dicts have their keys sorted."""
    tree = as_tree(tree)
    rest = [as_tree(r) for r in rest]
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def tree_unflatten(like, leaves):
    """``leaves`` (in tree order) in the dict structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
