"""Nested-dict trees of tensors: the port's counterpart of ``jax.tree`` for
the parameter, gradient and optimizer-state trees. Leaves come in sorted-key
order, as ``jax.tree.leaves`` gives a dict's."""
from __future__ import annotations

from collections.abc import Callable, Iterable


def leaves(tree) -> list:
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]


def unflatten(like, values: Iterable):
    """A tree of ``like``'s structure holding ``values`` in leaf order."""
    return _build(like, iter(values))


def _build(node, it):
    # a module function, not a closure over ``it``: a recursive closure is a reference
    # cycle, which would keep ``values`` (a step's gradients) alive until the cyclic gc runs
    return {k: _build(node[k], it) for k in sorted(node)} if isinstance(node, dict) else next(it)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    return unflatten(tree, (fn(*xs) for xs in zip(leaves(tree), *(leaves(r) for r in rest))))
