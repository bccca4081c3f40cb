"""Nested-dict trees of tensors: the parameter, gradient and optimizer
state trees of the training path.

Leaves are walked in the order in which ``jax.tree.flatten`` walks a
nested dict: keys sorted, depth first. The checkpoint's ``leaf_i`` numbering
follows that order, so a checkpoint written by either package restores
into the other's template.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple

__all__ = ["leaves", "map_tree", "paths", "unflatten"]


def paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs, keys sorted, depth first."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in paths(tree)]


def map_tree(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(template, new_leaves: Sequence[Any]):
    """A tree of `template`'s structure holding `new_leaves` in leaf order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
