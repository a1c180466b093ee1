"""Minimal pytree walks over nested dicts, lists and tuples.

Stands in for ``jax.tree_util`` in the port: dict children are visited in
sorted key order and sequence children in order, so the leaf order of a
tree of plain containers matches ``jax.tree_util.tree_flatten``. Anything
that is not a dict, list or tuple is a leaf (``None`` included).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map"]


def _keys(d: dict) -> List[Any]:
    return sorted(d, key=lambda k: (type(k).__name__, k))


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``; ``spec`` is picklable and rebuilds the tree with
    :func:`tree_unflatten`."""
    leaves: List[Any] = []

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            keys = _keys(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, None, [walk(c) for c in node])
        leaves.append(node)
        return ("leaf", None, None)

    return leaves, walk(tree)


def tree_unflatten(spec: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(s: Any) -> Any:
        kind, keys, children = s
        if kind == "leaf":
            return next(it)
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, built))
        return built if kind == "list" else tuple(built)

    return build(spec)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [fn(leaf) for leaf in leaves])
