"""Nested dicts and lists of tensors, the port's pytrees: leaves in the
reference's flatten order (dict keys sorted, list items in order) and key
paths as ``jax.tree_util`` names them (a dict key, or ``#i`` for a list
item)."""
from __future__ import annotations

from typing import Any, Iterator

__all__ = ["leaves", "leaves_with_paths", "unflatten", "get_path", "set_path", "path_name"]


def leaves_with_paths(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs; a path is a tuple of dict keys and list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template: Any, values: list) -> Any:
    """``template``'s structure with its leaves replaced, in flatten order,
    by ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than the template has leaves")
    return out


def get_path(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree: Any, path: tuple, value: Any) -> None:
    """Set ``tree[path] = value``, making the dicts and lists on the way
    (an int key makes a list, padded with None)."""
    for k, nxt in zip(path[:-1], path[1:]):
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(tree, list):
            while len(tree) <= k:
                tree.append(None)
            if tree[k] is None:
                tree[k] = empty
        elif k not in tree:
            tree[k] = empty
        tree = tree[k]
    last = path[-1]
    if isinstance(tree, list):
        while len(tree) <= last:
            tree.append(None)
    tree[last] = value


def path_name(path: tuple) -> str:
    """The checkpoint key of a path: parts joined by ``/``, list items as
    ``#i``."""
    return "/".join(f"#{p}" if isinstance(p, int) else str(p) for p in path)
