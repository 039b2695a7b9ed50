"""Gradient compression for the MA / sync-SGD baselines.

EC-DNN itself needs no gradient traffic between aggregations (that is
its point); these serve the baselines the paper compares against:

  - top-k sparsification with error feedback (the dropped residual is
    added back next step, preserving convergence),
  - symmetric per-tensor int8 quantization for the wire format.

They act on any tree of tensors, tensor by tensor, as the JAX package's
do on a pytree.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map


def topk_compress_with_feedback(grads, residuals, frac: float = 0.01):
    """Keep the top-`frac` fraction of entries (by |g|) of each tensor.

    -> (sparse_grads, new_residuals).  sparse + residual == grad exactly."""
    def one(g, r):
        g = g.float() + r
        k = max(1, int(g.numel() * frac))
        thresh = torch.topk(g.abs().reshape(-1), k).values[-1]
        kept = g * (g.abs() >= thresh).float()
        return kept, g - kept

    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(residuals))]
    kept, res = iter([o[0] for o in out]), iter([o[1] for o in out])
    return (tree_map(lambda _: next(kept), grads),
            tree_map(lambda _: next(res), grads))


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_residuals(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
