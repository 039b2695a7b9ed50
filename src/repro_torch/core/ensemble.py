"""Model aggregation: ensemble (Eqn 6) vs model-average (Eqn 3).

All functions take a leading member axis K.  `ensemble_probs` averages
member OUTPUTS; every standard loss is convex in the output distribution,
so by Jensen L(G_E(x), y) <= (1/K) sum_k L(f(w_k; x), y), and
`jensen_gap` returns that (always >= 0) slack.  `ma_average` averages
member PARAMETERS, for which no such bound exists.  The serving engine
fuses in log space with `ensemble_log_probs` under a (K,) quorum vector,
so a dropped member contributes exactly nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.tree import tree_map


def member_log_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def ensemble_probs(member_logits: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   average_probs: bool = True) -> torch.Tensor:
    """(K, ..., V) member logits -> (..., V) ensemble distribution.

    average_probs=True is the paper's Eqn 6 (mean of softmax outputs);
    False averages logits first (geometric-mean ensemble).  `weights`
    (K,) reweights members (straggler drop); they are normalized to 1."""
    K = member_logits.shape[0]
    w = torch.ones((K,), device=member_logits.device) if weights is None \
        else weights.float()
    w = w / w.sum().clamp_min(1e-9)
    wb = w.reshape((K,) + (1,) * (member_logits.dim() - 1))
    if average_probs:
        p = torch.softmax(member_logits.float(), dim=-1)
        return (p * wb).sum(dim=0)
    lg = (member_logits.float() * wb).sum(dim=0)
    return torch.softmax(lg, dim=-1)


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


def ensemble_nll(member_logits: torch.Tensor, labels: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy of the ensemble distribution against int labels."""
    p = ensemble_probs(member_logits, weights)
    gold = p.gather(-1, labels.long()[..., None])[..., 0]
    return -torch.log(gold.clamp_min(1e-30)).mean()


def mean_member_nll(member_logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean over members of each member's cross-entropy; labels are
    shared by the members, (...) or (K, ...)."""
    lp = member_log_probs(member_logits)
    y = labels.long().expand(member_logits.shape[:-1])
    gold = lp.gather(-1, y[..., None])[..., 0]
    return -gold.flatten(1).mean(1).mean()


def jensen_gap(member_logits: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """mean_k L(f_k) - L(ensemble) — provably >= 0 (paper Eqns 4-5)."""
    return mean_member_nll(member_logits, labels) \
        - ensemble_nll(member_logits, labels)


def ma_average(stacked_params, weights: Optional[torch.Tensor] = None):
    """Parameter mean over the leading member axis, broadcast back to K
    (the MA-DNN aggregation); `weights` (K,) as in ensemble_probs."""
    def avg(w):
        K = w.shape[0]
        if weights is None:
            m = w.mean(dim=0, keepdim=True)
        else:
            ww = weights.float() / weights.float().sum().clamp_min(1e-9)
            m = (w * ww.reshape((K,) + (1,) * (w.dim() - 1))).sum(
                dim=0, keepdim=True)
        return m.expand_as(w).to(w.dtype).contiguous()

    return tree_map(avg, stacked_params)
