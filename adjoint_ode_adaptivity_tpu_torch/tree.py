"""Nested parameter containers (dicts, tuples, lists of tensors): the small
part of JAX's pytree utilities the NN strand needs."""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves", "tree_unflatten"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which share its structure; ``None`` leaves stay ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the order :func:`tree_map` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in :func:`tree_leaves`
    order, by ``leaves``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
