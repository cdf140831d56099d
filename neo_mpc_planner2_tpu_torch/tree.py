"""A minimal tree map over the port's containers (dataclasses, NamedTuples,
tuples, lists, dicts), standing in for `jax.tree.map`, and its flatten and
unflatten (`jax.tree.flatten`). Tensor leaves are mapped; None and
non-tensor fields (such as a Costmap's `win_cells`) are kept as they
are."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["tree_map", "tree_flatten", "tree_unflatten"]


def tree_map(fn, tree, *rest):
    """fn(leaf, *leaves_at_same_place) over every tensor leaf of `tree`."""
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return tree


def tree_flatten(tree):
    """(tensor leaves in tree_map's order, treedef): the treedef is a
    hashable description of everything else, the containers' types and
    field names and the non-tensor fields' values (None, ints)."""
    leaves = []

    def walk(t):
        if torch.is_tensor(t):
            leaves.append(t)
            return None
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return (type(t), tuple((f.name, walk(getattr(t, f.name)))
                                   for f in dataclasses.fields(t)))
        if isinstance(t, (tuple, list)):
            return (type(t), tuple(walk(x) for x in t))
        if isinstance(t, dict):
            return (dict, tuple((k, walk(v)) for k, v in t.items()))
        return ("value", t)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """The tree that tree_flatten described by `treedef`, with `leaves` in
    place of its tensor leaves."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, rest = d
        if kind == "value":
            return rest
        if kind is dict:
            return {k: build(v) for k, v in rest}
        if dataclasses.is_dataclass(kind):
            return kind(**{name: build(v) for name, v in rest})
        if hasattr(kind, "_fields"):
            return kind(*(build(v) for v in rest))
        return kind(build(v) for v in rest)

    return build(treedef)
