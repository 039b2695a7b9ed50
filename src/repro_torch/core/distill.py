"""Compression-phase loss (paper Eqn 9) and the lambda schedule.

  L = CE(f(x), y_true) + lambda * CE(f(x), y_pseudo)

y_pseudo is the ensemble output distribution: dense (..., V) probs, or
a core/compression.TopM accumulator at LM vocabularies.  lambda anneals
linearly from lam0 to 0 over p steps (paper: lam0=0.5, p=tau/2), so the
compression phase is the start of the next local-training phase.  The
dense dual CE goes through kernels/ops.fused_distill_loss: the
hand-written CUDA kernel pair on the card, its plain version on the
CPU.  The top-M branch is plain PyTorch, as it is plain jnp in the JAX
package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.sharding import REP, constrain, is_dtensor
from repro_torch.core import compression as comp
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


def _topm_ce(logp: torch.Tensor, t: comp.TopM) -> torch.Tensor:
    t = comp.normalize(t)
    w = t.vals / t.vals.sum(-1).clamp_min(1e-30)[..., None]
    gathered = logp.gather(-1, t.idx.clamp_min(0).long())
    gathered = torch.where(t.idx < 0, 0.0, gathered)
    return -(w * gathered).sum(-1).mean()


def pseudo_ce_topm(logits: torch.Tensor, t: comp.TopM) -> torch.Tensor:
    """Sparse CE against a TopM target, mean over rows.  Only the kept
    classes contribute (the pruned mass's CE is unknowable after
    compression); the targets are renormalized over the kept entries,
    so the loss stays a proper CE up to the documented L1 bound."""
    return _topm_ce(torch.log_softmax(logits.float(), dim=-1), t)


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """log_softmax over the last dim in f32.  Over a DTensor (the
    dry-run's logits, the vocab sharded over "model") it is formed from
    the row's max and its sum of exponentials, each reduced across the
    shards (two small all-reduces), where DTensor's own log_softmax
    would gather every row whole."""
    x = logits.float()
    if not is_dtensor(x):
        return torch.log_softmax(x, dim=-1)
    lead = (None,) * (x.dim() - 1)
    m = constrain(x.detach().amax(-1, keepdim=True), *lead, REP)
    s = constrain(torch.exp(x - m).sum(-1, keepdim=True), *lead, REP)
    return x - (m + torch.log(s))


def _gold_nll(logp: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if is_dtensor(logp):
        # the label's entry by a select and a sum over the sharded vocab
        hit = torch.arange(logp.shape[-1], device=labels.device) \
            == labels.long()[..., None]
        gold = torch.where(hit, logp, 0.0).sum(-1)
    else:
        gold = logp.gather(-1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return -(gold * mask).sum() / mask.sum().clamp_min(1.0)
    return -gold.mean()


def true_ce(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _gold_nll(_log_softmax(logits), labels, mask)


def mixed_ce(logits: torch.Tensor, labels: torch.Tensor, pseudo,
             lam) -> torch.Tensor:
    """Eqn 9, mean over rows.  pseudo=None degrades to plain CE; dense
    pseudo-labels (..., V) go through the fused kernel (one launch over
    all rows each way on the card); a TopM target shares one log-softmax
    between the two CE terms."""
    if pseudo is None:
        return true_ce(logits, labels)
    if isinstance(pseudo, comp.TopM):
        logp = _log_softmax(logits)
        return _gold_nll(logp, labels) + lam * _topm_ce(logp, pseudo)
    if not torch.is_tensor(pseudo):
        raise TypeError(f"pseudo-labels are dense probs or a "
                        f"core/compression.TopM, not {type(pseudo).__name__}")
    return ops.fused_distill_loss(logits, labels, pseudo, lam)
