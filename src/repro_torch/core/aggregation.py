"""Aggregation for EC-DNN (the ensemble relabel) and the MA baseline.

allgather_relabel: every member scores every member's relabel batch and
  the K outputs are fused (Eqn 6) into each batch's pseudo-labels: dense
  probs, or top-M accumulators (label_mode="topk") — the JAX package's
  dense oracle.  The port scores the K batches concatenated, a chunk of
  rows at a time and member by member, adding each member's weighted
  output into one ensemble.StreamingEnsemble per chunk (`stream_logits`),
  so at most one member's logits over one chunk are live; the result is
  the same.  At gemma3's 262k vocabulary a member's logits over a K = 4
  relabel set of 22 sequences of 64 tokens a member would be 5.9 GB in
  f32.  A model that routes tokens by pool (a MoE: which tokens share a
  call decides which are dropped) scores each batch as its own pool,
  as the JAX package does: a chunk holds whole batches, and the MoE
  layers pool each batch's rows apart (transformer.apply's pool_rows),
  or, where one batch does not fit, a piece of one, its MoE layers
  carrying their arrival counts from piece to piece (apply's carry).

  Over a mesh (common/sharding.py, one process a rank, each holding
  K/M members and their batches), the batches, which are small, are
  all-gathered; each rank scores all K with its own members into a
  partial sum, and a reduce-scatter hands each rank only its own
  batches' targets (at gemma3's vocabulary the (K, n, T, V) sum is
  gigabytes: no rank needs all of it).

ring_relabel: the JAX package's ring, with data moving instead of
  weights.  Each rank holds one member and its relabel batch; it scores
  its own batch, then K-1 hops each pass (batch, accumulator) to the
  next rank along the axis (ring_hop: sharding.ppermute) and merge
  (ring_merge) the visiting batch's score (ring_score) into the
  accumulator, and one last hop brings each accumulator home.  Dense
  accumulators add; top-M ones merge (compression.merge of
  from_dense's candidates).  A hop moves the batch's rows and the
  accumulator, never weights.  The dry-run (launch/specs.py) accounts
  the ring by tracing those three functions on DTensors.

ma_aggregate: parameter mean over the member axis (MA-DNN), an
  all-reduce over a mesh; psum_gradients: the sync-SGD baseline's
  all-reduce mean of gradients.

Straggler policy: a (K,) 0/1 quorum mask; dropped members contribute
nothing and the rest renormalize to 1/(K-r).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import torch

from repro_torch.common import sharding as shd
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.common.types import ECConfig
from repro_torch.core import compression as comp
from repro_torch.core import ensemble as ens

# f32 one scoring call may hold: logits of 1,024 token rows at gemma3's
# 262k vocabulary, or one layer's output of 1,365 images of 32x32 at
# the paper's NiN width
CHUNK_BYTES = 1 << 30


def chunk_rows(inputs: dict, n_out: int, row_floats: int = 0) -> int:
    """Input rows (images, or sequences of T tokens) one scoring call
    takes, so that its f32 logits over n_out classes stay within
    CHUNK_BYTES, and so do row_floats f32 a row, the model's largest
    activation (models.activation_floats: a K = 8 CIFAR-100 relabel set
    of 35,000 images in one call would hold 27.5 GB of one NiN layer)."""
    per_row = n_out
    if "tokens" in inputs:
        per_row *= inputs["tokens"].shape[-1]
    return max(1, CHUNK_BYTES // (4 * max(per_row, row_floats)))


def stream_logits(stacked_params, inputs: dict, logits_fn: Callable,
                  n_out: int, fold: bool = False,
                  pool_rows: Optional[int] = None, row_floats: int = 0
                  ) -> Iterator[Tuple[slice, int, torch.Tensor]]:
    """Score inputs {name: (n, ...)}, shared by every member, a chunk of
    chunk_rows rows at a time and, within it, member by member.  ->
    yields (rows, member k, member k's logits (len(rows), ..., V)).
    fold=True scores the K members in one call when all their logits
    fit CHUNK_BYTES (the eval's test rows; the relabel's rows are
    already K members' batches, so it scores a member at a time).
    pool_rows: the rows of one token pool, passed on to logits_fn.  A
    chunk then holds whole pools, as many as fit; where one pool does
    not fit, its chunks are pieces of it, and each member carries its
    MoE layers' arrival counts from one piece to the next (logits_fn's
    carry, a dict started afresh at each pool).  row_floats: see
    chunk_rows.
    logits_fn takes member-stacked params and a batch with a leading
    member axis, as steps.make_logits_fn's do."""
    K = tree_leaves(stacked_params)[0].shape[0]
    n = tree_leaves(inputs)[0].shape[0]
    rows = chunk_rows(inputs, n_out, row_floats)
    kw = {} if pool_rows is None else {"pool_rows": pool_rows}

    def members(sl, carries=None):
        chunk = {name: v[None, sl] for name, v in inputs.items()}
        for k in range(K):
            member = tree_map(lambda x: x[k:k + 1], stacked_params)
            carry = {} if carries is None else {"carry": carries[k]}
            yield sl, k, logits_fn(member, chunk, **kw, **carry)[0]

    if fold and K * n <= rows:
        logits = logits_fn(stacked_params, {
            name: v[None].expand(K, *v.shape) for name, v in inputs.items()},
            **kw)
        for k in range(K):
            yield slice(0, n), k, logits[k]
        return
    if pool_rows is None or pool_rows <= rows:
        if pool_rows is not None:
            rows = rows // pool_rows * pool_rows
        for s in range(0, n, rows):
            yield from members(slice(s, min(s + rows, n)))
        return
    for p0 in range(0, n, pool_rows):
        end = min(p0 + pool_rows, n)
        carries = [{} for _ in range(K)]
        for s in range(p0, end, rows):
            yield from members(slice(s, min(s + rows, end)), carries)


@torch.no_grad()
def allgather_relabel(stacked_params, batches: dict, logits_fn: Callable,
                      ec: ECConfig, quorum: Optional[torch.Tensor] = None,
                      *, n_out: int, pooled: bool = False, mesh=None,
                      axis: str = "data", row_floats: int = 0):
    """-> pseudo-labels for each member's own batch: dense probs (K, n,
    ..., V), or a TopM with leading (K, n, ...) in label_mode "topk".

    stacked_params: tree with leading K; batches: dict of (K, n, ...)
    tensors (each member's relabel inputs); n_out: the classes (V) the
    logits span; pooled: the model routes tokens by pool
    (steps.routes_by_pool), so each batch is scored as its own;
    row_floats: the model's largest activation a row (chunk_rows).  With
    a mesh, stacked_params and batches are this rank's K/M rows along
    `axis`, quorum is the global (K,) mask, and so is the result's
    leading axis this rank's K/M."""
    if mesh is not None:
        return _allgather_relabel_mesh(stacked_params, batches, logits_fn,
                                       ec, quorum, n_out, pooled, mesh,
                                       axis, row_floats)
    K, n = tree_leaves(batches)[0].shape[:2]
    every = {name: v.reshape(K * n, *v.shape[2:])
             for name, v in batches.items()}
    device = tree_leaves(batches)[0].device
    out = fused = None
    for sl, k, logits in stream_logits(stacked_params, every, logits_fn,
                                       n_out,
                                       pool_rows=n if pooled else None,
                                       row_floats=row_floats):
        if k == 0:
            fused = ens.StreamingEnsemble(K, quorum, ec.average_probs,
                                          device)
        fused.add(k, logits)
        if k < K - 1:
            continue
        probs = fused.probs()
        res = comp.from_dense(probs, ec.top_m) \
            if ec.label_mode == "topk" else probs
        if out is None:
            out = tree_map(lambda x: x.new_empty((K * n, *x.shape[1:])),
                           res)
        tree_map(lambda o, x: o[sl].copy_(x), out, res)
    return tree_map(lambda o: o.reshape(K, n, *o.shape[1:]), out)


def _allgather_relabel_mesh(params, batches, logits_fn, ec, quorum, n_out,
                            pooled, mesh, axis, row_floats):
    """Every rank scores all K batches (all-gathered) with its own
    members into a partial weighted sum; a reduce-scatter leaves each
    rank the sum over its own batches' rows."""
    Kl, n = tree_leaves(batches)[0].shape[:2]
    K = Kl * shd.axis_size(mesh, axis)
    lo = shd.axis_index(mesh, axis) * Kl
    every = {name: shd.all_gather(v, mesh, axis).reshape(K * n,
                                                         *v.shape[2:])
             for name, v in batches.items()}
    device = tree_leaves(batches)[0].device
    partial = fused = None
    for sl, k, logits in stream_logits(params, every, logits_fn, n_out,
                                       pool_rows=n if pooled else None,
                                       row_floats=row_floats):
        if k == 0:
            fused = ens.StreamingEnsemble(K, quorum, ec.average_probs,
                                          device)
        fused.add(lo + k, logits)
        if k < Kl - 1:
            continue
        if partial is None:
            partial = fused.acc.new_empty((K * n, *fused.acc.shape[1:]))
        partial[sl] = fused.acc
    mine = shd.reduce_scatter(partial, mesh, axis)     # (Kl * n, ..., V)
    del partial
    probs = mine if ec.average_probs else torch.softmax(mine, dim=-1)
    res = comp.from_dense(probs, ec.top_m) if ec.label_mode == "topk" \
        else probs
    return tree_map(lambda o: o.reshape(Kl, n, *o.shape[1:]), res)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """softmax over the last dim.  Over a DTensor (the dry-run's logits,
    the vocabulary split over "model") by its two reductions, so that
    only the row maxima and sums cross ranks, as in XLA's sharded
    softmax, not the logits."""
    if not shd.is_dtensor(x):
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


@torch.no_grad()
def ring_score(stacked_params, visiting: dict, logits_fn: Callable,
               ec: ECConfig, weight: float = 1.0, *, n_out: int,
               pooled: bool = False, row_floats: int = 0):
    """A ring hop's work on one rank: its one member (stacked_params
    with a leading 1) scores the visiting rows {name: (n, ...)}, a chunk
    at a time (stream_logits) -> its output times `weight` (its quorum
    entry), dense (n, ..., V) probs (or logits, average_probs=False) or
    a TopM.  The top-M is taken per vocabulary shard where the logits
    are a DTensor split over "model" (compression.from_dense_sharded;
    from_dense on one shard)."""
    n = tree_leaves(visiting)[0].shape[0]
    acc = None
    for sl, _, logits in stream_logits(stacked_params, visiting, logits_fn,
                                       n_out,
                                       pool_rows=n if pooled else None,
                                       row_floats=row_floats):
        lg = logits.float()
        out = (_softmax(lg) if ec.average_probs else lg) * weight
        if ec.label_mode == "topk":
            out = comp.from_dense_sharded(out, ec.top_m,
                                          shd.mesh_axis_size("model", out))
        if sl.start == 0 and sl.stop >= n:      # one chunk: no copy
            return out
        if acc is None:
            acc = tree_map(lambda x: x.new_empty((n, *x.shape[1:])), out)
        tree_map(lambda a, x: a[sl].copy_(x), acc, out)
    return acc


def ring_merge(acc, part, ec: ECConfig):
    """Fold a hop's score into the accumulator: a sum of dense outputs
    (in place), a merge of TopMs."""
    return comp.merge(acc, part) if ec.label_mode == "topk" \
        else acc.add_(part)


def ring_hop(tree, mesh, axis: str):
    """Every tensor of `tree` (the visiting batch, an accumulator) passed
    to the next rank along `axis` (sharding.ppermute)."""
    return tree_map(lambda x: shd.ppermute(x, mesh, axis), tree)


@torch.no_grad()
def ring_relabel(mesh, stacked_params, batches: dict, logits_fn: Callable,
                 ec: ECConfig, axis: str = "data",
                 quorum: Optional[torch.Tensor] = None, *, n_out: int,
                 pooled: bool = False, row_floats: int = 0):
    """The ring over `axis`: this rank's one member (stacked_params with
    a leading 1) and its batch (dict of (1, n, ...)) -> its batch's
    pseudo-labels with a leading 1, dense or TopM as allgather_relabel.
    quorum: the global (K,) 0/1 mask (None: every member); the sum
    divides by max(sum(quorum), 1).  Raises unless the axis holds one
    member a rank (its size is K).  A hop is ring_hop, ring_score,
    ring_merge: the dry-run accounts the ring by the same three."""
    if tree_leaves(stacked_params)[0].shape[0] != 1:
        raise ValueError(
            f"ring_relabel holds one member a rank, but this rank holds "
            f"{tree_leaves(stacked_params)[0].shape[0]}: the ring axis "
            f"{axis!r} must have K ranks (use allgather_relabel)")
    K = shd.axis_size(mesh, axis)
    me = shd.axis_index(mesh, axis)
    if quorum is not None and quorum.shape[0] != K:
        raise ValueError(f"quorum has {quorum.shape[0]} entries, the ring "
                         f"{K} members")
    w_me = 1.0 if quorum is None else float(quorum[me])
    # the rows travel without their labels: no member reads them
    batch = {name: v[0] for name, v in batches.items() if name != "labels"}
    kw = dict(n_out=n_out, pooled=pooled, row_floats=row_floats)
    acc = ring_score(stacked_params, batch, logits_fn, ec, w_me, **kw)
    for _ in range(K - 1):
        batch, acc = ring_hop((batch, acc), mesh, axis)
        acc = ring_merge(acc, ring_score(stacked_params, batch, logits_fn,
                                         ec, w_me, **kw), ec)
    acc = ring_hop(acc, mesh, axis)                    # home
    denom = float(K) if quorum is None else max(float(quorum.sum()), 1.0)
    if ec.label_mode == "topk":
        return comp.TopM(*[x[None] for x in comp.scale(acc, 1.0 / denom)])
    return (acc / denom)[None]


@torch.no_grad()
def ma_aggregate(stacked_params, quorum: Optional[torch.Tensor] = None,
                 mesh=None, axis: str = "data"):
    """MA-DNN: the parameter mean over the member axis; over a mesh,
    stacked_params are this rank's rows and quorum its slice of the
    global mask (core.ensemble.ma_average)."""
    return ens.ma_average(stacked_params, weights=quorum, mesh=mesh,
                          axis=axis)


def psum_gradients(grads, mesh, axis: str):
    """The sync-SGD baseline: the all-reduce mean of grads over the
    ranks of `axis`."""
    return tree_map(lambda g: shd.pmean(g, mesh, axis), grads)
