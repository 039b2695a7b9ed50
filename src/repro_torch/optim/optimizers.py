"""Minimal optimizers over member-stacked parameter trees.

An Optimizer is an (init, update) pair:
    state = opt.init(params)
    params, state = opt.update(grads, state, params)
The JAX package vmaps the same pair over the member axis; here the
member axis is written out: every leaf has a leading K, the step count
is (K,) int32 and a gradient-norm clip is taken per member, so each
ensemble member carries independent optimizer state under the JAX
layout {"mu", "step"}.  `update` is functional (new tensors, nothing
updated in place) and runs without autograd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _per_member(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(K,) -> broadcastable against a (K, ...) leaf."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def clip_by_global_norm(grads, max_norm: float):
    """Scale each member's gradients to a global norm <= max_norm.
    -> (grads, (K,) norms before clipping)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(g.float().square().flatten(1).sum(1)
                        for g in leaves))
    scale = (max_norm / gn.clamp_min(1e-9)).clamp_max(1.0)
    return tree_map(lambda g: g * _per_member(scale, g).to(g.dtype),
                    grads), gn


def sgd_momentum(lr, momentum: float = 0.9, weight_decay: float = 0.0,
                 clip_norm: float = 0.0) -> Optimizer:
    """The paper's Section 5.1 optimizer (momentum + l2).  `lr` is a
    float or a function of the (K,) step tensor returning a tensor on
    the step's device (a float lr never leaves the host)."""

    @torch.no_grad()
    def init(params):
        K = tree_leaves(params)[0].shape[0]
        dev = tree_leaves(params)[0].device
        return {"mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "step": torch.zeros((K,), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        if clip_norm > 0:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        lr_t = lr(step).float().expand(step.shape) if callable(lr) else lr
        mu = tree_map(
            lambda m, g, p: momentum * m + g.float()
            + weight_decay * p.float(), state["mu"], grads, params)

        def apply(p, m):
            lr_m = _per_member(lr_t, m) if callable(lr) else lr_t
            return (p.float() - lr_m * m).to(p.dtype)

        new_params = tree_map(apply, params, mu)
        return new_params, {"mu": mu, "step": step}

    return Optimizer(init, update)
