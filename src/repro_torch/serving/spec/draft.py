"""The draft side of ensemble-speculative decoding.

The distilled student (core/compression.py's EC-DNN_L output) runs as a
K = 1 member stack through the same slot-indexed cache machinery as its
teachers.  `propose` is the drafting loop of a speculative step: gamma+1
per-slot decode steps that build the verify chunk; `DraftEngine` serves
the student alone behind the ordinary engine API.

The draft pool is contiguous and sized max_seq + gamma: a slot near the
end of its budget drafts up to gamma positions past it, and the
contiguous decode writes at the position itself (it has no dropped
writes), so the slack keeps every draft write inside the plane.  The
draft's decode reads its planes through `attend`, as the contiguous
decode does; its prefill takes the flash kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.models import transformer as tf
from repro_torch.serving import kv_cache, sampling
from repro_torch.serving.engine import EnsembleEngine


def as_member_stack(params, like=None):
    """Student params -> a K = 1 member stack.  With `like` (a stacked
    tree of the teachers' architecture) params whose leaves already have
    its ranks pass through, and must hold one member; otherwise (and
    with like=None) a leading axis of 1 is added to every leaf (a
    view)."""
    if like is not None:
        l0 = tree_leaves(params)[0]
        if l0.dim() == tree_leaves(like)[0].dim():
            if l0.shape[0] != 1:
                raise ValueError(
                    f"draft stack carries K={l0.shape[0]} members; the "
                    f"draft model must be a single student (K=1)")
            return params
    return tree_map(lambda x: x.unsqueeze(0), params)


def init_draft_pool(cfg, n_slots: int, max_seq: int, gamma: int,
                    device=None) -> dict:
    """The draft's K = 1 contiguous pool with the + gamma slack (module
    docstring)."""
    return kv_cache.init_pool(cfg, 1, n_slots, max_seq + gamma,
                              device=device)


def load_draft(root: str, like) -> Tuple[dict, int]:
    """The newest committed student at a checkpoint root (the port's
    checkpoint/store.py), restored as a K = 1 stack shaped after the
    teachers' stack `like` (its member axis cut to 1), or as unstacked
    params, whichever the checkpoint holds.  -> (params, step)."""
    from repro_torch.checkpoint.store import latest_step, restore_checkpoint
    step = latest_step(root)
    if step is None:
        raise ValueError(f"{root}: no committed checkpoint")
    stacked = tree_map(lambda x: x[:1], like)
    try:
        return restore_checkpoint(root, step, stacked), step
    except ValueError:
        return restore_checkpoint(root, step,
                                  tree_map(lambda x: x[0], like)), step


def propose(draft_params, cfg, cache: dict, tok: torch.Tensor, gamma: int,
            sample: Optional[Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]] = None):
    """Draft gamma tokens a slot and write their K/V into the draft pool.

    cache: the draft pool (idx (1, B) = each row's position); tok (B,)
    the last accepted token, the chunk's first entry.  gamma+1 decode
    steps: step j consumes chunk[j] at position idx + j and proposes
    chunk[j+1]; the last one only writes d_gamma's K/V (its logits go
    unused: the bonus token is the verifier's).

    sample=None drafts greedily.  Otherwise (temperature (B,), top_k
    (B,), gumbel (B, gamma, V)): rows with temperature > 0 draw each
    proposal from the tempered, top-k-masked student distribution by
    Gumbel-max with the given noise; the others stay greedy.

    -> (chunk (B, gamma+1) int64, draft_lp (B, gamma, V) the log-probs
    each proposal was drawn from, None on the greedy path, and the cache
    with idx advanced by gamma+1)."""
    cols, lps = [tok], []
    cur = tok
    for j in range(gamma + 1):
        lg, cache = tf.decode_step_slots(draft_params, cfg, cache,
                                         cur[:, None])   # (1, B, 1, V)
        if j == gamma:
            break
        row = lg[0, :, 0].float()
        nxt = row.argmax(dim=-1)
        if sample is not None:
            temp, top_k, gumbel = sample
            lp = torch.log_softmax(row, dim=-1)
            stoch = temp > 0
            masked = sampling.top_k_mask_rows(lp, torch.where(stoch, top_k, 0))
            scaled = masked / temp.clamp_min(1e-6)[:, None]
            drawn = (scaled + gumbel[:, j]).argmax(dim=-1)
            nxt = torch.where(stoch, drawn, nxt)
            lps.append(torch.where(stoch[:, None],
                                   torch.log_softmax(scaled, dim=-1), lp))
        cols.append(nxt)
        cur = nxt
    draft_lp = torch.stack(lps, dim=1) if lps else None
    return torch.stack(cols, dim=1), draft_lp, cache


class DraftEngine(EnsembleEngine):
    """The compressed student behind the full serving API, K = 1: the
    reference the speculative engine's in-step draft is held against,
    and the way to serve the student alone (the paper's EC-DNN_L).
    Continuous batching, paging and quorum (trivial at K = 1) are the
    engine's own."""

    def __init__(self, cfg, student_params, **kw):
        super().__init__(cfg, as_member_stack(student_params), **kw)
