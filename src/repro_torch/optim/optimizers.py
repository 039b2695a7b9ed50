"""Minimal optimizers over member-stacked parameter trees.

An Optimizer is an (init, update) pair:
    state = opt.init(params)
    params, state = opt.update(grads, state, params)
The JAX package vmaps the same pair over the member axis; here the
member axis is written out: every leaf has a leading K, the step count
is (K,) int32 and a gradient-norm clip is taken per member, so each
ensemble member carries independent optimizer state under the JAX
layouts ({"mu", "step"}, {"m", "v", "step"}).  Both updates run without
autograd.  `sgd_momentum`'s update is functional (new tensors);
`adamw`'s updates params and moments in place (see there).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.common.sharding import is_dtensor
from repro_torch.common.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _per_member(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(K,) -> broadcastable against a (K, ...) leaf."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


# leaves up to _ONE_PASS elements update in one pass; larger ones member
# by member, each member's slice in pieces of at most _PIECE elements,
# so that the f32 temporaries stay small (a jamba expert leaf's member
# slice is 939M elements: 3.8 GB a temporary in f32)
_ONE_PASS = _PIECE = 1 << 25


def _pieces(x: torch.Tensor):
    """Flat views of x's member slices (x contiguous), in pieces of at
    most _PIECE elements, member 0's first."""
    return [piece for k in range(x.shape[0])
            for piece in x[k].view(-1).split(_PIECE)]


def _sq_norms(g: torch.Tensor) -> torch.Tensor:
    """(K,) f32 squared norms of each member's slice of g (K, ...),
    reduced piece by piece (the f32 cast copies what it reduces)."""
    flat = g.reshape(g.shape[0], -1)
    return sum(torch.linalg.vector_norm(flat[:, i:i + _PIECE], dim=1,
                                        dtype=torch.float32).square()
               for i in range(0, flat.shape[1], _PIECE))


def _sharded_sq_norms(g):
    """_sq_norms of a DTensor (the dry-run's sharded state): each shard's
    own, summed over the mesh dims that split a member -> (K,) DTensor,
    its member dim laid out as g's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    pl = [q if isinstance(q, Shard) and q.dim == 0
          else (Partial() if isinstance(q, Shard) else Replicate())
          for q in g.placements]
    sq = DTensor.from_local(_sq_norms(g.to_local()), g.device_mesh, pl,
                            run_check=False, shape=torch.Size(g.shape[:1]),
                            stride=(1,))
    return sq.redistribute(g.device_mesh, [Replicate() if isinstance(
        q, Partial) else q for q in pl])


def _member_local(x: torch.Tensor, like) -> torch.Tensor:
    """A (K,) vector's entries for the members a DTensor leaf's shard
    holds, as a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = like.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    want = [q if isinstance(q, Shard) and q.dim == 0 else Replicate()
            for q in like.placements]
    return x.redistribute(mesh, want).to_local()


def _clip_scale(grads, max_norm: float):
    """-> ((K,) factors that bring each member's global gradient norm to
    <= max_norm, (K,) norms), each leaf's norm reduced in f32 (a large
    leaf piece by piece: the f32 cast copies what it reduces)."""
    gn = torch.sqrt(sum(_sharded_sq_norms(g) if is_dtensor(g)
                        else _sq_norms(g) for g in tree_leaves(grads)))
    return (max_norm / gn.clamp_min(1e-9)).clamp_max(1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """Scale each member's gradients to a global norm <= max_norm.
    -> (grads, (K,) norms before clipping)."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * _per_member(scale, g).to(g.dtype),
                    grads), gn


def sgd_momentum(lr, momentum: float = 0.9, weight_decay: float = 0.0,
                 clip_norm: float = 0.0) -> Optimizer:
    """The paper's Section 5.1 optimizer (momentum + l2).  `lr` is a
    float or a function of the (K,) step tensor returning a tensor on
    the step's device (a float lr never leaves the host)."""

    @torch.no_grad()
    def init(params):
        K = tree_leaves(params)[0].shape[0]
        dev = tree_leaves(params)[0].device
        return {"mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "step": torch.zeros((K,), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        if clip_norm > 0:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        lr_t = lr(step).float().expand(step.shape) if callable(lr) else lr
        mu = tree_map(
            lambda m, g, p: momentum * m + g.float()
            + weight_decay * p.float(), state["mu"], grads, params)

        def apply(p, m):
            lr_m = _per_member(lr_t, m) if callable(lr) else lr_t
            return (p.float() - lr_m * m).to(p.dtype)

        new_params = tree_map(apply, params, mu)
        return new_params, {"mu": mu, "step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW under the JAX package's state layout {"m", "v", "step"}.
    `lr` is a float or a schedule of the (K,) step tensor
    (optim/schedules.py); the clip is per member.

    `update` works IN PLACE: the moments, the step and the params given
    to it are overwritten and returned, the port's counterpart of the
    JAX package's donated state.  A functional update would hold a second
    copy of params and moments at its peak (K = 4 full-width gemma3-1b:
    8 GB of bf16 params, 32 GB of f32 moments), more than the card has.
    The math is the JAX package's, in f32 whatever the storage types;
    a clipped gradient is scaled in its own dtype first, as there."""

    @torch.no_grad()
    def init(params):
        leaf = tree_leaves(params)[0]
        z = lambda p: torch.zeros(p.shape, dtype=moment_dtype,  # noqa: E731
                                  device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": torch.zeros((leaf.shape[0],), dtype=torch.int32,
                                    device=leaf.device)}

    def one(p, g, m, v, s, lr_t, c1, c2):
        """The update of one part (a leaf, or one member's slice of it);
        s, lr_t, c1, c2 broadcast against it."""
        g = g * s.to(g.dtype) if s is not None else g
        mf, vf = m.float(), v.float()
        mf.mul_(b1).add_(g, alpha=1 - b1)
        vf.mul_(b2).addcmul_(g, g, value=1 - b2)
        if mf is not m:  # stored rounded, and the step reads them so
            m.copy_(mf)
            v.copy_(vf)
            mf, vf = m.float(), v.float()
        den = (vf / c2).sqrt_().add_(eps)
        delta = (mf / c1).div_(den)
        del den
        delta.add_(p, alpha=weight_decay)
        p.sub_(delta.mul_(lr_t))

    def leaf(p, g, m, v, vecs):
        """One leaf's update in place; vecs (K,) per member or None."""
        if p.numel() <= _ONE_PASS:
            one(p, g, m, v, *(None if x is None else _per_member(x, p)
                              for x in vecs))
            return
        # in place on views of params and moments; the gradient is only
        # read
        per_member = -(-p[0].numel() // _PIECE)
        parts = zip(*(_pieces(x) for x in (p, g.contiguous(), m, v)))
        for i, (pp, gp, mp, vp) in enumerate(parts):
            k = i // per_member
            one(pp, gp, mp, vp, *(None if x is None else x[k]
                                  for x in vecs))

    @torch.no_grad()
    def update(grads, state, params):
        scale = _clip_scale(grads, clip_norm)[0] if clip_norm > 0 else None
        step = state["step"]
        step += 1
        lr_t = lr(step).float() if callable(lr) else \
            torch.full(step.shape, lr, dtype=torch.float32,
                       device=step.device)
        sf = step.float()
        c1 = 1.0 - torch.pow(b1, sf)
        c2 = 1.0 - torch.pow(b2, sf)
        vecs = (scale, lr_t, c1, c2)
        for p, g, m, v in zip(*(tree_leaves(t) for t in (
                params, grads, state["m"], state["v"]))):
            if is_dtensor(p):
                # shard by shard, in place on the local tensors, each with
                # the entries of its own members
                leaf(*(x.to_local() for x in (p, g, m, v)),
                     [None if x is None else _member_local(x, p)
                      for x in vecs])
            else:
                leaf(p, g, m, v, vecs)
        return params, state

    return Optimizer(init, update)
