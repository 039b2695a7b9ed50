"""Model aggregation: ensemble (Eqn 6) vs model-average (Eqn 3).

The stacked functions take a leading member axis K; `StreamingEnsemble`
takes one member at a time (the trainer's relabel and eval, where K
members' logits at an LM vocabulary would not fit).  `ensemble_probs`
averages member OUTPUTS; every standard loss is convex in the output
distribution, so by Jensen L(G_E(x), y) <= (1/K) sum_k L(f(w_k; x), y),
and `jensen_gap` returns that (always >= 0) slack.  `ma_average` averages
member PARAMETERS, for which no such bound exists.  The serving engine
fuses in log space with `ensemble_log_probs` under a (K,) quorum vector,
so a dropped member contributes exactly nothing; over a member mesh
(common/sharding.py: one rank a shard of the member axis) with
`ensemble_log_probs_psum`, and `ma_average` takes the mesh too.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.tree import tree_map


def member_log_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


class StreamingEnsemble:
    """Eqn 6 over members that arrive one at a time, so that no more
    than one member's logits need be live: `add` member k's (..., V)
    logits, then `probs` -> the (..., V) ensemble distribution.

    average_probs=True accumulates sum_k w_k softmax(z_k), the paper's
    Eqn 6; False accumulates sum_k w_k z_k and takes its softmax (the
    geometric-mean ensemble).  `weights` (K,) reweights members
    (straggler drop); they are normalized to 1."""

    def __init__(self, K: int, weights: Optional[torch.Tensor] = None,
                 average_probs: bool = True, device=None):
        w = torch.ones((K,), device=device) if weights is None \
            else weights.float()
        self.w = w / w.sum().clamp_min(1e-9)
        self.average_probs = average_probs
        self.acc = None

    def add(self, k: int, logits: torch.Tensor) -> None:
        lg = logits.float()
        part = (torch.softmax(lg, dim=-1) if self.average_probs else lg) \
            * self.w[k]
        self.acc = part if self.acc is None else self.acc.add_(part)

    def probs(self) -> torch.Tensor:
        return self.acc if self.average_probs \
            else torch.softmax(self.acc, dim=-1)


def gold_nll(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(..., V) distribution, (...) int labels -> (...) -log p[label]."""
    gold = probs.gather(-1, labels.long()[..., None])[..., 0]
    return -torch.log(gold.clamp_min(1e-30))


def member_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(..., V) logits, (...) int labels -> (...) cross-entropy."""
    lp = member_log_probs(logits)
    return -lp.gather(-1, labels.long()[..., None])[..., 0]


def ensemble_probs(member_logits: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   average_probs: bool = True) -> torch.Tensor:
    """(K, ..., V) member logits -> (..., V) ensemble distribution, by
    StreamingEnsemble."""
    K = member_logits.shape[0]
    fused = StreamingEnsemble(K, weights, average_probs,
                              member_logits.device)
    for k in range(K):
        fused.add(k, member_logits[k])
    return fused.probs()


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


def ensemble_log_probs_psum(member_logits: torch.Tensor,
                            weights: Optional[torch.Tensor] = None,
                            mesh=None, axis: str = "member",
                            member_lp: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Eqn-6 fusion of a member-sharded ensemble: member_logits are this
    rank's (K_local, ..., V) rows of the member axis and weights the
    matching slice of the global (K,) quorum.  Each rank fuses its own
    members in log space and the ranks combine with one all-reduce MAX
    and one all-reduce SUM over `axis`, so that only fused (..., V)
    partials cross ranks:

        log sum_k w_k softmax(z_k) = m + log(sum_r sum_{k in r}
                                             exp(log w_k + log p_k - m)),
        m = max_r max_{k in r} (log w_k + log p_k)

    The weights normalize globally (an all-reduce SUM of the local
    weight mass), so a zero-weight member contributes nothing and the
    rest renormalize, as in ensemble_log_probs.  Every rank gets the
    same bits: the all-reduces hand each rank the same sums.  member_lp:
    the member log-probs when the caller has them."""
    from repro_torch.common import sharding as shd
    K = member_logits.shape[0]
    w = torch.ones((K,), device=member_logits.device) if weights is None \
        else weights.float()
    w = w / shd.psum(w.sum(), mesh, axis).clamp_min(1e-9)
    logw = torch.log(w.clamp_min(1e-30)).reshape(
        (K,) + (1,) * (member_logits.dim() - 1))
    lp = (member_log_probs(member_logits) if member_lp is None
          else member_lp) + logw
    m = shd.pmax(lp.amax(dim=0), mesh, axis)
    s = shd.psum((lp - m[None]).exp().sum(dim=0), mesh, axis)
    return m + torch.log(s)


def prunable_members(member_logits: torch.Tensor,
                     fused_log_probs: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     member_lp: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Members whose whole vote mass cannot flip the fused argmax: member
    j is skippable at a position when the mixture without it, base_j =
    T - w_j softmax(z_j), already leads its runner-up by more than w_j,
    since then argmax(base_j + w_j p_j) == argmax(base_j) whatever j
    voted.  member_logits (K, ..., V); fused_log_probs (..., V) the fused
    Eqn-6 log distribution; weights the normalized (K,) quorum (None:
    uniform 1/K); member_lp the member log-probs when the caller has
    them.  -> (K, ...) bool.  Telemetry for speculative verify: it
    prices a skip and never changes a token."""
    K = member_logits.shape[0]
    w = (torch.full((K,), 1.0 / K, device=member_logits.device)
         if weights is None else weights.float())
    wb = w.reshape((K,) + (1,) * (fused_log_probs.dim() - 1))
    T = fused_log_probs.float().exp()[None]
    p = (member_lp.exp() if member_lp is not None
         else torch.softmax(member_logits.float(), dim=-1))
    base = (T - wb[..., None] * p).clamp_min(0.0)
    top = base.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1] > wb


def ensemble_nll(member_logits: torch.Tensor, labels: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy of the ensemble distribution against int labels."""
    return gold_nll(ensemble_probs(member_logits, weights), labels).mean()


def mean_member_nll(member_logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean over members of each member's cross-entropy; labels are
    shared by the members, (...) or (K, ...)."""
    y = labels.long().expand(member_logits.shape[:-1])
    return member_nll(member_logits, y).flatten(1).mean(1).mean()


def jensen_gap(member_logits: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """mean_k L(f_k) - L(ensemble) — provably >= 0 (paper Eqns 4-5)."""
    return mean_member_nll(member_logits, labels) \
        - ensemble_nll(member_logits, labels)


def ma_average(stacked_params, weights: Optional[torch.Tensor] = None,
               mesh=None, axis: str = "member"):
    """Parameter mean over the leading member axis, broadcast back to K
    (the MA-DNN aggregation); `weights` (K,) as in ensemble_probs.  Over
    a mesh, stacked_params are this rank's rows and weights their slice
    of the global quorum: the weighted sum of each leaf is all-reduced
    over `axis` (in f32) and divided by the global weight mass."""
    if mesh is not None:
        return _ma_average_mesh(stacked_params, weights, mesh, axis)

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


def _ma_average_mesh(stacked_params, weights, mesh, axis: str):
    from repro_torch.common import sharding as shd
    from repro_torch.common.tree import tree_leaves
    K = tree_leaves(stacked_params)[0].shape[0]
    dev = tree_leaves(stacked_params)[0].device
    w = torch.ones((K,), device=dev) if weights is None \
        else weights.float().to(dev)
    mass = shd.psum(w.sum(), mesh, axis).clamp_min(1e-9)

    def avg(x):
        wb = w.reshape((K,) + (1,) * (x.dim() - 1))
        total = shd.psum((x.float() * wb).sum(dim=0, keepdim=True), mesh,
                         axis)
        return (total / mass).expand_as(x).to(x.dtype).contiguous()

    return tree_map(avg, stacked_params)
