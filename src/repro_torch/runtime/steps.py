"""Step functions shared by the Trainer and the launch layer.

The JAX package vmaps a per-member loss over the member axis; here all K
members run in one pass: the CNN folds them into the channels of grouped
convolutions (models/cnn.py), the transformer batches them in every op
(models/transformer.py), and the Eqn-9 loss of all K members is one
fused-kernel launch over all K*B rows each way.  The models this covers:
the CNN (paper NiN) and every transformer family (attention, rwkv6's
"ssm", jamba's "hybrid").  The transformer's forward-only route
(relabel, eval) goes through the attention and recurrence kernels; its
training route (apply(remat=True)) through their plain forms, which
autograd differentiates.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.common.sharding import is_dtensor, layout_ctx
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.common.types import ModelConfig, ParallelConfig
from repro_torch.core import compression as comp
from repro_torch.core import distill
from repro_torch.optim import Optimizer

L2 = 1e-4  # the paper's weight l2 on conv kernels (Section 5.1)


def make_logits_fn(cfg: ModelConfig) -> Callable:
    """(member-stacked params, batch {images (K, B, H, W, C)} or {tokens
    (K, B, T)}, or embeds (K, B, T, d) in the tokens' place, and
    enc_embeds (K, B, S, d) for an encoder-decoder) -> logits (K, B,
    [T,] V), forward only (relabel, eval):
    the transformer's attention and recurrences go through the flash,
    wkv6 and ssm_scan kernels.  The transformer's also takes pool_rows,
    the rows of one MoE token pool, and carry, for a call over a piece
    of one (transformer.apply)."""
    if cfg.family == "cnn":
        from repro_torch.models import cnn
        return lambda params, batch: cnn.nin_apply(params, batch["images"])
    from repro_torch.models import transformer
    return lambda params, batch, pool_rows=None, carry=None: \
        transformer.apply(params, cfg, batch.get("tokens"),
                          pool_rows=pool_rows, carry=carry,
                          embeds=batch.get("embeds"),
                          enc_embeds=batch.get("enc_embeds"))[0]


def routes_by_pool(cfg: ModelConfig) -> bool:
    """Does a layer of cfg route its tokens as a pool (a MoE, whose
    capacity drops tokens), so that which rows share a call changes the
    output?"""
    return cfg.family != "cnn" and any(
        spec.ffn == "moe" for _, specs in cfg.segments() for spec in specs)


def _rows(pseudo, V: int):
    """Pseudo-labels (K, B, ..., V) or a TopM with leading (K, B, ...) ->
    one row per output position."""
    if pseudo is None:
        return None
    if isinstance(pseudo, comp.TopM):
        M = pseudo.vals.shape[-1]
        return comp.TopM(pseudo.vals.reshape(-1, M),
                         pseudo.idx.reshape(-1, M), pseudo.rest.reshape(-1))
    return pseudo.reshape(-1, V)


def make_member_loss(cfg: ModelConfig) -> Callable:
    """(params, batch, pseudo, lam) -> scalar: the SUM over members of
    each member's Eqn-9 loss (+ l2 on the CNN's kernels, + the MoE aux
    loss) on its own batch, so that its gradient with respect to member
    k's params is member k's own gradient.  The CE is the mean over all
    K*B(*T) rows, i.e. 1/K of the members' summed means: it is scaled by
    K.  The transformer takes its training route (apply(remat=True))."""
    if cfg.family == "cnn":
        from repro_torch.models import cnn

        def cnn_loss(params, batch, pseudo, lam):
            logits = cnn.nin_apply(params, batch["images"])
            K, V = logits.shape[0], logits.shape[-1]
            ce = distill.mixed_ce(logits.reshape(-1, V),
                                  batch["labels"].reshape(-1),
                                  _rows(pseudo, V), lam)
            return K * ce + L2 * cnn.l2_reg(params).sum()
        return cnn_loss

    from repro_torch.models import transformer

    def lm_loss(params, batch, pseudo, lam):
        logits, aux = transformer.apply(params, cfg, batch.get("tokens"),
                                        remat=True,
                                        embeds=batch.get("embeds"),
                                        enc_embeds=batch.get("enc_embeds"))
        K, V = logits.shape[0], logits.shape[-1]
        ce = distill.mixed_ce(logits.reshape(-1, V),
                              batch["labels"].reshape(-1),
                              _rows(pseudo, V), lam)
        return K * ce + (aux.sum() if torch.is_tensor(aux) else aux)
    return lm_loss


def microbatch(tree, i: int, accum: int):
    """Microbatch i of accum of every member's rows (K, B, ...): rows i,
    i + accum, ... (the JAX package's split), as a view through (B /
    accum, accum): a batch sharded over its rows keeps every
    microbatch's rows on their shard (a strided slice would gather
    them)."""
    if tree is None:
        return None
    B = tree_leaves(tree)[0].shape[1]
    return tree_map(lambda x: x.unflatten(1, (B // accum, accum))[:, :, i],
                    tree)


def make_member_grads(cfg: ModelConfig, grad_accum: int = 1) -> Callable:
    """(params, batch, pseudo, lam) -> (the members' summed loss, a 0-d
    tensor, grads).  grad_accum > 1 splits every member's batch into
    microbatches (`microbatch`) and means their losses and gradients,
    the gradients in f32 accumulators.  The returned fn's `micro` and
    `finish` are that loop's body and its end: the dry-run traces a
    microbatch apart through them and counts it grad_accum times."""
    member_loss = make_member_loss(cfg)

    def grads_of(params, batch, pseudo, lam):
        leaves = tree_leaves(params)
        total = member_loss(params, batch, pseudo, lam)
        grads = torch.autograd.grad(total, leaves)
        # a DTensor gradient (the dry-run's) is reduced into its
        # parameter's layout as it is made (partial sums over the batch
        # shards settled a microbatch at a time, as FSDP does)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if is_dtensor(g) else g for g, p in zip(grads, leaves)]
        return total.detach(), grads

    def micro(params, batch, pseudo, lam, i, acc=None, loss=0.0):
        """Microbatch i's gradients added into acc (made at the first:
        f32 zeros) and its loss into loss -> (acc, loss).  A function of
        its own, so that the microbatch's gradients die with it."""
        l_i, g_i = grads_of(params, microbatch(batch, i, grad_accum),
                            microbatch(pseudo, i, grad_accum), lam)
        if acc is None:
            acc = [torch.zeros_like(g, dtype=torch.float32) for g in g_i]
        for a, g in zip(acc, g_i):
            a.add_(g)
        return acc, loss + l_i

    def finish(acc, loss):
        """The mean over the microbatches, in place -> (loss, grads)."""
        inv = 1.0 / grad_accum
        return loss * inv, [a.mul_(inv) for a in acc]

    def fn(params, batch, pseudo, lam):
        if grad_accum <= 1:
            loss, flat = grads_of(params, batch, pseudo, lam)
        else:
            B = tree_leaves(batch)[0].shape[1]
            if B % grad_accum:
                raise ValueError(f"batch {B} does not split into "
                                 f"{grad_accum} microbatches")
            acc, loss = None, 0.0
            for i in range(grad_accum):
                acc, loss = micro(params, batch, pseudo, lam, i, acc, loss)
            loss, flat = finish(acc, loss)
        it = iter(flat)
        return loss, tree_map(lambda _: next(it), params)
    fn.micro, fn.finish = micro, finish
    return fn


def make_local_step(cfg: ModelConfig, opt: Optimizer, grad_accum: int = 1,
                    sync: bool = False, mesh=None, axis: str = "data",
                    par: Optional[ParallelConfig] = None,
                    data_axis: Optional[str] = None) -> Callable:
    """EC local-training step over member-stacked state.

    (state {params, opt}, batch, pseudo, lam) -> (state, mean loss over
    members, a 0-d tensor on the state's device).  pseudo=None is the
    plain-CE step; sync=True all-reduces (means) the gradients over the
    member axis first (the sync-SGD baseline): over a mesh, this rank's
    members' mean is averaged over the ranks of `axis`
    (aggregation.psum_gradients), every rank holding as many members.
    data_axis: a mesh dim whose ranks hold the same members, each an
    equal share of every member's batch rows; the gradients are averaged
    over it before the optimizer's clip and step, so that they are the
    whole batch's (the loss stays the share's).
    An optimizer that updates in place (adamw) returns the state's own
    tensors; the loss is this rank's members' mean.  `par` names the
    layout roles of the dry-run's DTensor state (the member batch's axes,
    the sequence axis; models' constrain sites).  The returned step's
    `member_grads` and `apply` are its two halves (the gradients, the
    optimizer's update) and `layout()` the context the first runs in:
    the dry-run traces them apart."""
    member_grads = make_member_grads(cfg, grad_accum)
    batch_axes = tuple(par.batch_axes) if par is not None else ()
    seq_axis = (par.seq_axis or None) if par is not None else None

    def layout():
        return layout_ctx(batch=batch_axes, seq=seq_axis, train=True)

    def apply(state, total, grads):
        if mesh is not None and (sync or data_axis):
            from repro_torch.core import aggregation as agg
        if data_axis is not None:
            grads = agg.psum_gradients(grads, mesh, data_axis)
        if sync:
            mean = tree_map(lambda g: g.mean(0, keepdim=True), grads)
            if mesh is not None:
                mean = agg.psum_gradients(mean, mesh, axis)
            grads = tree_map(lambda m, g: m.expand_as(g), mean, grads)
        new_params, new_opt = opt.update(grads, state["opt"],
                                         state["params"])
        K = tree_leaves(state["params"])[0].shape[0]
        return {"params": new_params, "opt": new_opt}, total / K

    def step(state, batch, pseudo, lam):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        with layout():
            total, grads = member_grads(params, batch, pseudo, lam)
        return apply(state, total, grads)
    step.member_grads, step.apply, step.layout = member_grads, apply, layout
    return step


def make_serve_fns(cfg: ModelConfig, par: Optional[ParallelConfig] = None):
    """(prefill_fn, decode_fn) for single-model serving, the dry-run's
    prefill and decode cells: prefill_fn(params, batch) ->
    transformer.prefill's (last logits, argmax); decode_fn(params, cache,
    tokens) -> transformer.decode_step_slots's (logits, cache) over an
    init_slot_cache cache."""
    from repro_torch.models import transformer
    batch_axes = tuple(par.batch_axes) if par is not None else \
        ("pod", "data")

    def prefill_fn(params, batch):
        with layout_ctx(batch=batch_axes):
            return transformer.prefill(params, cfg, batch.get("tokens"),
                                       embeds=batch.get("embeds"),
                                       enc_embeds=batch.get("enc_embeds"))

    def decode_fn(params, cache, tokens):
        with layout_ctx(batch=batch_axes):
            return transformer.decode_step_slots(params, cfg, cache, tokens)

    return prefill_fn, decode_fn
