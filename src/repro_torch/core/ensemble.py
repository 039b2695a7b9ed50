"""Ensemble fusion of the K members' outputs (the paper's Eqn 6).

All functions take a leading member axis K.  The serving engine fuses
in log space with `ensemble_log_probs` under a (K,) quorum vector, so a
dropped member contributes exactly nothing.
"""
from __future__ import annotations

from typing import Optional

import torch


def member_log_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def quorum_weights(mask: torch.Tensor) -> torch.Tensor:
    """(K,) 0/1 liveness mask -> normalized member weights: dropped
    members get exactly 0 and the rest renormalize to 1/(K-r).  An
    all-zero quorum falls back to uniform rather than dividing by 0."""
    m = mask.float()
    alive = m.sum()
    return torch.where(alive > 0, m / alive.clamp_min(1.0),
                       torch.ones_like(m) / m.shape[0])


def ensemble_log_probs(member_logits: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       member_lp: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(K, ..., V) member logits -> (..., V) log of the Eqn-6 mixture,
    log sum_k w_k softmax(z_k), by logsumexp.  Zero-weight members
    contribute -inf mass, i.e. exactly nothing."""
    K = member_logits.shape[0]
    if weights is None:
        w = torch.full((K,), 1.0 / K, device=member_logits.device)
    else:
        w = weights.float() / weights.float().sum().clamp_min(1e-9)
    logw = torch.log(w.clamp_min(1e-30)).reshape(
        (K,) + (1,) * (member_logits.dim() - 1))
    lp = member_log_probs(member_logits) if member_lp is None else member_lp
    return torch.logsumexp(lp + logw, dim=0)
