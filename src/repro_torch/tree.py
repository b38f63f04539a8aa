"""Parameter trees: nested lists, tuples and dicts of tensors.

The port keeps the JAX package's parameter layout (a network is a list of
dicts of tensors, NOS and OFA stages add a 0-d ``choice`` and int-keyed
dicts), so the optimizers and training loops walk those trees with these
helpers in place of ``jax.tree_util``.  Dict entries are visited in sorted
key order, as ``jax.tree_util`` visits them, so a sum over the leaves adds
them in the reference's order.  ``None`` is a leaf (an unused gradient).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Tree = Any


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves in ``tree_map``'s order."""
    return list(_iter_leaves(tree))


def _iter_leaves(tree: Tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_leaves(v)
    else:
        yield tree


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (which have ``tree``'s structure), in a new tree of
    that structure."""
    return tree_map_with_path(lambda _path, *leaves: fn(*leaves), tree,
                              *rest)


def tree_map_with_path(fn: Callable, tree: Tree, *rest: Tree,
                       path: Tuple = ()) -> Tree:
    """As ``tree_map``, with the leaf's path of keys and indices as
    ``fn``'s first argument."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=path + (i,))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)
