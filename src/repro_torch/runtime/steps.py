"""Step functions shared by the Trainer and the launch layer.

The JAX package vmaps a per-member loss over the member axis; here all K
members run in one pass: the CNN folds them into the channels of grouped
convolutions (models/cnn.py), and the Eqn-9 loss of all K members is one
fused-kernel launch over K*B rows each way.  The models this covers so
far: the CNN (paper NiN).  LM training waits for its slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.common.types import ModelConfig
from repro_torch.core import distill
from repro_torch.optim import Optimizer

L2 = 1e-4  # the paper's weight l2 on conv kernels (Section 5.1)


def _cnn_only(cfg: ModelConfig) -> None:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"training the {cfg.family!r} family is not ported yet (LM "
            f"training: ROADMAP queue 1 item 6); the port trains the CNN")


def make_logits_fn(cfg: ModelConfig) -> Callable:
    """(member-stacked params, batch {images (K, B, H, W, C)}) ->
    logits (K, B, V)."""
    _cnn_only(cfg)
    from repro_torch.models import cnn
    return lambda params, batch: cnn.nin_apply(params, batch["images"])


def make_member_loss(cfg: ModelConfig) -> Callable:
    """(params, batch, pseudo, lam) -> scalar: the SUM over members of
    each member's Eqn-9 loss + l2 on its own batch, so that its gradient
    with respect to member k's params is member k's own gradient.  The
    fused loss is the mean over all K*B rows, i.e. 1/K of the members'
    summed means: it is scaled by K before the gradient."""
    _cnn_only(cfg)
    from repro_torch.models import cnn

    def cnn_loss(params, batch, pseudo, lam):
        logits = cnn.nin_apply(params, batch["images"])
        K, V = logits.shape[0], logits.shape[-1]
        ps = None if pseudo is None else pseudo.reshape(-1, V)
        ce = distill.mixed_ce(logits.reshape(-1, V),
                              batch["labels"].reshape(-1), ps, lam)
        return K * ce + L2 * cnn.l2_reg(params).sum()
    return cnn_loss


def make_local_step(cfg: ModelConfig, opt: Optimizer,
                    sync: bool = False) -> Callable:
    """EC local-training step over member-stacked state.

    (state {params, opt}, batch, pseudo, lam) -> (state, mean loss over
    members, a 0-d tensor on the state's device).  pseudo=None is the
    plain-CE step; sync=True all-reduces (means) the gradients over the
    member axis first (the sync-SGD baseline)."""
    member_loss = make_member_loss(cfg)

    def step(state, batch, pseudo, lam):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        total = member_loss(params, batch, pseudo, lam)
        flat = torch.autograd.grad(total, tree_leaves(params))
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        if sync:
            grads = tree_map(lambda g: g.mean(0, keepdim=True).expand_as(g),
                             grads)
        new_params, new_opt = opt.update(grads, state["opt"],
                                         state["params"])
        K = tree_leaves(params)[0].shape[0]
        return {"params": new_params, "opt": new_opt}, total.detach() / K
    return step
