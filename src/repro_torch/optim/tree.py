"""Parameter trees: nested dicts whose leaves are tensors, walked in the
reference's leaf order (dict keys sorted, as ``jax.tree_util`` sorts
them)."""

from __future__ import annotations

from typing import Any, Callable, List, Sequence


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """``leaves`` (in :func:`tree_leaves`' order) put in ``like``'s
    structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_unzip(tree: Any, n: int) -> List[Any]:
    """A tree whose leaves are ``n``-tuples -> ``n`` trees."""
    return [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]
