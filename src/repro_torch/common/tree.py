"""Maps over parameter trees: nested dicts, lists and tuples of tensors
(the JAX package's pytrees, as the port keeps them)."""
from __future__ import annotations

from typing import Callable, List

import torch


def tree_map(fn: Callable, tree, *rest):
    """fn applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in a fixed order (dict insertion order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
