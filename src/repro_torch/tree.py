"""Nested-dict trees of tensors, flattened in the order JAX flattens them.

``jax.tree.flatten`` visits a dict's keys in sorted order at every level,
so the reference's leaf lists — its gradient buckets, its optimizer loop,
its global norm — follow sorted keys.  The port keeps that order, so its
bucket bins and its sums are the reference's.  A leaf is anything that is
not a dict.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, dict keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    out = build(like)
    if next(it, it) is not it:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    return tree_unflatten(tree, [fn(*xs) for xs in zip(
        tree_leaves(tree), *(tree_leaves(r) for r in rest))])
