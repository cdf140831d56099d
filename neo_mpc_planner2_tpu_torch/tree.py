"""A minimal tree map over the port's containers (dataclasses, NamedTuples,
tuples, lists, dicts), standing in for `jax.tree.map`. Tensor leaves are
mapped; None and non-tensor fields (such as a Costmap's `win_cells`) are
kept as they are."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["tree_map"]


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
