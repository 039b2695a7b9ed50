"""Compression-phase loss (paper Eqn 9) and the lambda schedule.

  L = CE(f(x), y_true) + lambda * CE(f(x), y_pseudo)

y_pseudo is the ensemble output distribution, dense (..., V) probs on
the faithful CIFAR path.  lambda anneals linearly from lam0 to 0 over p
steps (paper: lam0=0.5, p=tau/2), so the compression phase is the start
of the next local-training phase.  The dense dual CE goes through
kernels/ops.fused_distill_loss: the hand-written CUDA kernel pair on the
card, its plain version on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def lam_schedule(step_in_round, lam0: float, p_steps: int) -> torch.Tensor:
    """Linear anneal lam0 -> 0 over p steps, 0 afterwards (Section 4.3).
    A step tensor on the card gives lambda on the card (no host copy)."""
    step = torch.as_tensor(step_in_round, dtype=torch.float32)
    if p_steps <= 0:
        return torch.zeros_like(step)
    frac = 1.0 - step / p_steps
    return lam0 * frac.clamp(0.0, 1.0)


def pseudo_ce_dense(logits: torch.Tensor,
                    pseudo_probs: torch.Tensor) -> torch.Tensor:
    """-sum_c p̄_c log softmax(logits)_c, mean over rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(pseudo_probs * logp).sum(-1).mean()


def true_ce(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = logp.gather(-1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return -(gold * mask).sum() / mask.sum().clamp_min(1.0)
    return -gold.mean()


def mixed_ce(logits: torch.Tensor, labels: torch.Tensor, pseudo,
             lam) -> torch.Tensor:
    """Eqn 9, mean over rows.  pseudo=None degrades to plain CE; dense
    pseudo-labels (..., V) go through the fused kernel (one launch over
    all rows each way on the card)."""
    if pseudo is None:
        return true_ce(logits, labels)
    if not torch.is_tensor(pseudo):
        raise NotImplementedError(
            "top-M pseudo-labels (label_mode='topk') need "
            "core/compression.py, not ported yet (ROADMAP queue 1 item 6)")
    return ops.fused_distill_loss(logits, labels, pseudo, lam)
