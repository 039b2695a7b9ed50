"""Maps over parameter trees: nested dicts, lists and tuples of tensors
(the JAX package's pytrees, as the port keeps them), NamedTuples
included."""
from __future__ import annotations

from typing import Callable, List, Optional

import torch


def tree_map(fn: Callable, tree, *rest):
    """fn applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        # a NamedTuple (core/compression.TopM) takes its fields as args
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in a fixed order (dict insertion order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map_with_path(fn: Callable, tree, path: tuple = (),
                       is_leaf: Optional[Callable] = None):
    """fn(path, leaf) over one tree; path holds the dict keys (str) and
    sequence indices (int) from the root.  is_leaf(x) marks subtrees to
    treat as leaves (a spec tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,), is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, path + (i,), is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(path, tree)
