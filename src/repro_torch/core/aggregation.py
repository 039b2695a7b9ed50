"""Aggregation for EC-DNN (the ensemble relabel) and the MA baseline.

allgather_relabel: every member scores every member's relabel batch and
  the K outputs are fused (Eqn 6) into each batch's pseudo-labels — the
  JAX package's dense oracle.  The port scores member by member over all
  K batches concatenated, so at most one member's activations are live
  (about a quarter of the JAX form's (K, K, n, ...) member x batch
  activations); the result is the same.

ma_aggregate: parameter mean over the member axis (MA-DNN).

The ring protocol (data rotating around a member mesh) waits for the
multi-device port (ROADMAP queue 1 item 12).  Straggler policy: a (K,)
0/1 quorum mask; dropped members contribute nothing and the rest
renormalize to 1/(K-r).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.common.types import ECConfig
from repro_torch.core import ensemble as ens


@torch.no_grad()
def allgather_relabel(stacked_params, batches: dict, logits_fn: Callable,
                      ec: ECConfig,
                      quorum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> dense pseudo-labels (K, n, ..., V) for each member's own batch.

    stacked_params: tree with leading K; batches: dict of (K, n, ...)
    tensors (each member's relabel inputs); logits_fn(params, batch)
    takes member-stacked params and a batch with a leading member axis
    and returns (K, n, ..., V)."""
    if ec.label_mode == "topk":
        raise NotImplementedError(
            "top-M pseudo-labels (label_mode='topk') need "
            "core/compression.py, not ported yet (ROADMAP queue 1 item 6)")
    K, n = tree_leaves(batches)[0].shape[:2]
    every = {k: v.reshape(1, K * n, *v.shape[2:]) for k, v in
             batches.items()}
    all_logits = []
    for m in range(K):
        member = tree_map(lambda x: x[m:m + 1], stacked_params)
        lg = logits_fn(member, every)              # (1, K*n, ..., V)
        all_logits.append(lg.reshape(K, n, *lg.shape[2:]))
    return ens.ensemble_probs(torch.stack(all_logits), weights=quorum,
                              average_probs=ec.average_probs)


@torch.no_grad()
def ma_aggregate(stacked_params, quorum: Optional[torch.Tensor] = None):
    return ens.ma_average(stacked_params, weights=quorum)
