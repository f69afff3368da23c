"""Nested-dict parameter trees, flattened in JAX's order.

JAX flattens a dict by sorted key, recursively; the port iterates its
gradient leaves in that same order, so the cross-leaf fp32 sums of the
statistics associate exactly as in the reference, and a JAX tree converts
leaf for leaf.  A tree is a dict of trees or a leaf (anything else).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Tree = Any
_END = object()


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves of ``tree`` in sorted key-path order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_items(tree: Tree, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in sorted key-path order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_unflatten(like: Tree, leaves: List[Any]) -> Tree:
    """A tree shaped like ``like`` holding ``leaves`` (tree_leaves order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    cols = [tree_leaves(t) for t in (tree,) + rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])
