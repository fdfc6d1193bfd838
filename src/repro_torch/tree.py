"""Param trees: nested dicts, lists and tuples with tensors at the leaves
(a bare tensor is a one-leaf tree), walked in ``jax.tree_util``'s flatten
order: dict keys sorted, sequences in order, a ``NamedTuple`` by its
fields; ``None`` is an empty subtree.  The optimizer and the checkpoints
walk the reference's trees in its order through these."""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["flatten", "leaves", "path_key", "tree_map", "tree_map_with_path"]


def _children(tree) -> list[tuple[Any, Any]] | None:
    """(path element, child) pairs of an inner node, None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten(tree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs in flatten order; a path is a tuple of dict keys,
    sequence indices and ``.field`` names."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, v in kids:
        yield from flatten(v, path + (k,))


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def path_key(path: tuple) -> str:
    """The reference checkpoint's key of a path: its elements joined by
    ``/`` (``.field`` for a ``NamedTuple`` field, as JAX prints it)."""
    return "/".join(str(e) for e in path)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), the structure of ``tree`` rebuilt."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, its structure
    rebuilt; paths as ``flatten`` gives them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)
