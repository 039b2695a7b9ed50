"""Top-M sparse pseudo-label accumulators (label_mode="topk").

At LM scale a dense per-token distribution is V floats (gemma3: 262k ->
1 MB a token in f32), so the relabel keeps, per token, the M largest
(prob, index) pairs plus a scalar `rest` holding the pruned mass.  Merge
is associative up to pruning; the pruned mass is tracked exactly, so the
accumulated distribution always sums to the true total and the L1 error
against the dense oracle is bounded by twice the pruned mass.

Layout, as in the JAX package: vals (..., M) f32 descending, idx (...,
M) int32, rest (...,) f32.  Padding entries have idx = -1, val = 0.

`torch.topk` promises no order among equal values, where the JAX
package's top_k takes the lower index first: on inputs with ties the two
may keep different, equally heavy, classes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common.sharding import constrain


class TopM(NamedTuple):
    vals: torch.Tensor   # (..., M) f32, descending
    idx: torch.Tensor    # (..., M) int32, -1 = empty
    rest: torch.Tensor   # (...,)  pruned probability mass


def from_dense(probs: torch.Tensor, m: int) -> TopM:
    """probs (..., V) -> TopM keeping the M heaviest classes."""
    vals, idx = torch.topk(probs, m, dim=-1)
    rest = probs.sum(-1) - vals.sum(-1)
    return TopM(vals.float(), idx.int(), rest.float())


def from_dense_sharded(probs: torch.Tensor, m: int, n_shards: int,
                       shard_axis: str = "model") -> TopM:
    """Top-M in two stages, as the JAX package's from_dense_sharded
    takes it over a vocabulary split n_shards ways: the M heaviest of
    each of n_shards equal slices of V, then the M heaviest of those
    n_shards * M candidates.  The global top M always lie among the
    slices' own, so the result is from_dense's (which it is, where V does not split evenly or where a slice holds
    fewer than M).  Over
    a DTensor the slice dim is pinned to `shard_axis`, so each shard's
    top-M is local and only the candidates cross ranks."""
    V = probs.shape[-1]
    if n_shards == 1 or V % n_shards or V // n_shards < m:
        return from_dense(probs, m)
    vs = V // n_shards
    p = constrain(probs.reshape(*probs.shape[:-1], n_shards, vs),
                  *(None,) * (probs.dim() - 1), shard_axis, None)
    lv, li = torch.topk(p, m, dim=-1)
    li = li + torch.arange(n_shards, device=probs.device)[:, None] * vs
    cand_v = lv.reshape(*probs.shape[:-1], n_shards * m)
    cand_i = li.reshape(*probs.shape[:-1], n_shards * m)
    gv, pos = torch.topk(cand_v, m, dim=-1)
    gi = cand_i.gather(-1, pos)
    rest = probs.sum(-1) - gv.sum(-1)
    return TopM(gv.float(), gi.int(), rest.float())


def zeros(batch_shape, m: int, device=None) -> TopM:
    shape = tuple(batch_shape)
    return TopM(torch.zeros(shape + (m,), dtype=torch.float32,
                            device=device),
                torch.full(shape + (m,), -1, dtype=torch.int32,
                           device=device),
                torch.zeros(shape, dtype=torch.float32, device=device))


def merge(a: TopM, b: TopM) -> TopM:
    """Union the 2M candidates, keep the M heaviest, demote the rest.

    Duplicate indices are combined first (a segment sum over the sorted
    union) so a class present in both inputs is counted once with its
    summed mass."""
    m = a.vals.shape[-1]
    vals = torch.cat([a.vals, b.vals], -1)                 # (..., 2M)
    idx = torch.cat([a.idx, b.idx], -1)
    order = torch.argsort(idx, dim=-1, stable=True)
    idx_s = idx.gather(-1, order)
    vals_s = vals.gather(-1, order)
    first = torch.cat([torch.ones_like(idx_s[..., :1], dtype=torch.bool),
                       idx_s[..., 1:] != idx_s[..., :-1]], -1)
    # a run's sum is the cumsum at its end minus the cumsum at the
    # previous run's end (the cumsum is nondecreasing: vals >= 0)
    csum = vals_s.cumsum(-1)
    run_end = torch.cat([first[..., 1:], torch.ones_like(first[..., :1])],
                        -1)
    prev_end = torch.cat([torch.zeros_like(csum[..., :1]),
                          torch.where(run_end, csum, 0.0)[..., :-1]], -1)
    prev_end = torch.cummax(prev_end, -1).values
    cand_vals = torch.where(run_end, csum - prev_end, 0.0)
    cand_idx = torch.where(run_end, idx_s, -1)
    cand_vals = torch.where(cand_idx < 0, 0.0, cand_vals)
    keep_vals, pos = torch.topk(cand_vals, m, dim=-1)
    keep_idx = cand_idx.gather(-1, pos)
    dropped = cand_vals.sum(-1) - keep_vals.sum(-1)
    return TopM(keep_vals, torch.where(keep_vals > 0, keep_idx, -1),
                a.rest + b.rest + dropped)


def scale(t: TopM, s) -> TopM:
    return TopM(t.vals * s, t.idx, t.rest * s)


def to_dense(t: TopM, vocab: int, spread_rest: bool = False) -> torch.Tensor:
    """Expand to (..., V).  spread_rest spreads the pruned mass
    uniformly."""
    idx = torch.where(t.idx < 0, vocab, t.idx).long()  # empties off-range
    dense = torch.zeros(t.vals.shape[:-1] + (vocab + 1,),
                        dtype=torch.float32, device=t.vals.device)
    dense = dense.scatter_add(-1, idx, t.vals.float())[..., :vocab]
    if spread_rest:
        dense = dense + t.rest[..., None] / vocab
    return dense


def normalize(t: TopM) -> TopM:
    inv = 1.0 / (t.vals.sum(-1) + t.rest).clamp_min(1e-30)
    return TopM(t.vals * inv[..., None], t.idx, t.rest * inv)


def l1_error_bound(t: TopM) -> torch.Tensor:
    """Guaranteed bound on ||topm - dense oracle||_1: twice the pruned
    mass."""
    return 2.0 * t.rest


def bytes_per_token(m: int) -> int:
    """Wire size of one token's accumulator entry (f32 val + i32 idx)."""
    return m * 8 + 4
