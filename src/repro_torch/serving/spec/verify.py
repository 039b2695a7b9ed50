"""Draft acceptance rules for ensemble-speculative decoding.

Plain tensor math over distributions already computed: the verify pass
hands in the fused Eqn-6 log-probs at every chunk position (fused[:, j]
is the ensemble's next-token distribution after chunk entry j) and the
student's proposal distributions; these decide how many drafted tokens
survive.

Greedy (the default): draft d_{j+1} survives iff it equals the fused
argmax c_j and every earlier draft survived, so the emitted tokens are
the fused ensemble's greedy chain: speculation changes the schedule,
never the text.

Stochastic (SpeculativeEngine(spec_sampling=True)): rejection sampling.
d is accepted with probability min(1, p(d) / q(d)) against the tempered
target p and the proposal q, a rejection resamples from the normalized
residual max(p - q, 0), and when every draft survives the bonus token
is drawn from p; the emitted tokens are then distributed as sequential
sampling from p.
"""
from __future__ import annotations

import torch


def greedy_accept(drafts: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """drafts (B, G) proposed tokens d_1..d_G; choice (B, >= G) fused
    greedy choices, choice[:, j] the argmax after chunk entry j.  -> (B,)
    accepted count a in [0, G]: the longest prefix with d_{j+1} == c_j."""
    G = drafts.shape[1]
    agree = (drafts == choice[:, :G]).long()
    return agree.cumprod(dim=1).sum(dim=1)


def stochastic_accept(u: torch.Tensor, drafts: torch.Tensor,
                      target_lp: torch.Tensor,
                      draft_lp: torch.Tensor) -> torch.Tensor:
    """Accept d_{j+1} iff u_j < p_j(d_{j+1}) / q_j(d_{j+1}), and every
    earlier draft was accepted.  u (B, G) uniforms; drafts (B, G);
    target_lp (B, >= G, V) fused log-probs (position j is the target of
    d_{j+1}); draft_lp (B, G, V) proposal log-probs.  -> (B,) count."""
    G = drafts.shape[1]
    g = drafts.long()[..., None]
    lp_p = target_lp[:, :G].gather(-1, g)[..., 0]
    lp_q = draft_lp.gather(-1, g)[..., 0]
    acc = (u < torch.exp((lp_p - lp_q).clamp_max(0.0))).long()
    return acc.cumprod(dim=1).sum(dim=1)


def residual_log_probs(target_lp: torch.Tensor,
                       draft_lp: torch.Tensor) -> torch.Tensor:
    """log of normalize(max(p - q, 0)), the resampling law after a
    rejection.  (..., V) log-probs in, (..., V) out.  Where the residual
    is empty (q covers p) the target itself stands in: acceptance is
    then certain and the row is never drawn from, but it stays finite."""
    r = (target_lp.exp() - draft_lp.exp()).clamp_min(0.0)
    rs = r.sum(dim=-1, keepdim=True)
    safe = torch.where(rs > 1e-9, r / rs.clamp_min(1e-9), target_lp.exp())
    return torch.log(safe.clamp_min(1e-30))
