"""Primitive layers: norms, rotary embeddings, MLPs, embeddings.

Params are plain dicts of tensors with the JAX package's leaf names.
Every weight carries a leading member axis K (the ensemble's stacked
layout), and activations carry it too: x is (K, ..., d).  The K members
run as one batched matmul (`mm`), never as a Python loop.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.common.sharding import REP, constrain, is_dtensor
from repro_torch.common.types import ModelConfig


class _ShapeOnly:
    """The init's generator on the meta device: it carries the device
    and draws nothing (a torch.Generator cannot live there)."""

    device = torch.device("meta")


def init_generator(seed: int, device: torch.device):
    """The generator an init draws from on `device`, seeded.  On the
    meta device, a stand-in: the init then makes every leaf with its
    shape and dtype and no storage (the port's jax.eval_shape of init),
    and draws nothing."""
    if device.type == "meta":
        return _ShapeOnly()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def dense_init(gen: torch.Generator, lead: Sequence[int], shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) weights of per-layer `shape`, stacked
    under the `lead` axes (members, segment count); fan_in = shape[-2].

    The leaf is allocated in `dtype` and filled one (member, layer)
    slice at a time through one reused f32 buffer, so init holds at most
    one slice in f32 beside the weights (a full-width 7B model at K = 4
    fits on one 80 GB card).  On the meta device it is left unfilled."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(*lead, *shape, dtype=dtype, device=gen.device)
    if w.is_meta:
        return w
    buf = torch.empty(*shape, dtype=torch.float32, device=gen.device)
    for part in w.view(-1, *shape):
        torch.randn(*shape, generator=gen, out=buf)
        part.copy_(buf.mul_(std))
    return w


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-member matmul: x (K, ..., d) @ w (K, d, n) -> (K, ..., n).
    A DTensor x sharded over more than one of its middle dims (the
    batch and the sequence, in a big arch's training) keeps only the
    first of them sharded before they fold into one, and so does the
    gradient of the output's unfold: DTensor's view rule (torch 2.11)
    refuses to fold two sharded dims."""
    if is_dtensor(x) and x.dim() > 3:
        x = one_sharded_middle(x)
        out = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]), w)
        return unfold(out, (*x.shape[:-1], w.shape[-1]))
    K = x.shape[0]
    out = torch.bmm(x.reshape(K, -1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def one_sharded_middle(x):
    """A DTensor (K, ..., d) with at most one of its middle dims sharded
    (the first that is; the others gathered), so that a reshape may fold
    them into one."""
    from torch.distributed.tensor import Replicate
    middle = sorted({p.dim for p in x.placements if p.is_shard()
                     and 0 < p.dim < x.dim() - 1})
    if len(middle) < 2:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard() and p.dim in middle[1:] else p
        for p in x.placements])


def unfold(x, shape):
    """x (K, n, d) reshaped to (K, ..., d) splitting its middle dim; over
    a DTensor its gradient is folded back after one_sharded_middle, as
    the forward's fold was."""
    return _Unfold.apply(x, tuple(shape)) if is_dtensor(x) \
        else x.reshape(shape)


class _Unfold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            g = one_sharded_middle(g)
        return g.reshape(ctx.shape), None


def member_view(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(K, n) per-member vector -> broadcastable against x (K, ..., n)."""
    return w.reshape(w.shape[0], *([1] * (x.dim() - 2)), w.shape[-1])


def shift_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (K, B, T, ...) moved n positions later along T, zeros first (a
    causal shift).  Built by a cat, not F.pad: DTensor's pad rule in
    torch 2.11 plans a redistribution its planner cannot run."""
    T = x.shape[2]
    n = min(n, T)
    return torch.cat([torch.zeros_like(x[:, :, :n]), x[:, :, :T - n]], 2)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * member_view(params["norm_scale"], xf)).to(dt)


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE) and sinusoidal positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Rotate x (..., seq, heads, head_dim) by positions (..., seq), where
    positions broadcasts against x's leading axes.  With `sections`
    (M-RoPE, qwen2-vl) positions are (3, ..., seq): frequency j of
    section s rotates by positions[s], the sections splitting the half
    dim in order."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if sections is None:
        angles = positions[..., None].float() * freqs  # (..., seq, half)
    else:
        ids = [s for s, n in enumerate(sections) for _ in range(n)]
        pos = positions[torch.tensor(ids, device=positions.device)]
        angles = pos.movedim(0, -1).float() * freqs
    cos = torch.cos(angles)[..., None, :]          # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None,
                         start: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(n, d) f32 table: sin(p * w_i) at even features, cos at odd ones,
    w_i = 10000^(-2i/d), for positions p = 0..n-1, or, given `start`
    (B,) int, positions start[b] + 0..n-1 per row -> (B, n, d)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)
    if start is not None:
        pos = start.float()[:, None] + pos
    rate = torch.tensor(-math.log(10000.0) / d, dtype=torch.float32)
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * rate.to(device))
    ang = pos[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).flatten(-2)


# ---------------------------------------------------------------------------
# MLP (swiglu / geglu / gelu)
# ---------------------------------------------------------------------------

def mlp_init(gen, lead, d_model: int, d_ff: int, mlp_type: str,
             dtype) -> dict:
    p = {"w_up": dense_init(gen, lead, (d_model, d_ff), dtype),
         "w_down": dense_init(gen, lead, (d_ff, d_model), dtype)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, lead, (d_model, d_ff), dtype)
    return p


def mlp_apply(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    up = mm(x, params["w_up"])
    if mlp_type == "swiglu":
        h = F.silu(mm(x, params["w_gate"])) * up
    elif mlp_type == "geglu":
        h = F.gelu(mm(x, params["w_gate"]), approximate="tanh") * up
    else:  # plain gelu
        h = F.gelu(up, approximate="tanh")
    h = constrain(h, *(None,) * (h.dim() - 1), "model")
    return mm(h, params["w_down"])


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------

def embed_init(gen, lead, vocab: int, d_model: int, dtype) -> dict:
    # GPT-style 0.02 std keeps tied-head logits sane at init
    return {"embed": dense_init(gen, lead, (vocab, d_model), dtype,
                                scale=0.02)}


def embed_lookup(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """tokens (B, T) shared by all members, or (K, B, T) with one batch
    per member (training) -> (K, B, T, d)."""
    table = params["embed"]
    if is_dtensor(table):
        x = _sharded_lookup(table, tokens)
    elif tokens.dim() == 3:
        k = torch.arange(table.shape[0], device=tokens.device)
        x = table[k[:, None, None], tokens.long()]
    else:
        x = table[:, tokens.long()]
    if cfg.scale_embeddings:
        # the scale is cast to the embed dtype first, as the JAX package does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _sharded_lookup(table, tokens: torch.Tensor) -> torch.Tensor:
    """embed_lookup over a DTensor table (the dry-run's; vocab sharded
    over "model").  One member: F.embedding, which DTensor runs on each
    vocab shard, masked, and sums (the JAX package's gather over a
    sharded operand).  Several: the indexed read.  Either way the rows
    come out whole over the hidden dim, the shards' sum taken."""
    if table.shape[0] == 1:
        tok = tokens if tokens.dim() == 2 else tokens[0]
        x = F.embedding(tok.long(), table[0]).unsqueeze(0)
    elif tokens.dim() == 3 and _members_alike(table, tokens):
        x = _masked_lookup(table, tokens)
    else:
        k = torch.arange(table.shape[0], device=tokens.device)
        x = table[k[:, None, None], tokens.long()] if tokens.dim() == 3 \
            else table[:, tokens.long()]
    return constrain(x, None, None, None, REP)


def _members_alike(table, tokens) -> bool:
    """Do a member-stacked (K, V, d) table and (K, B, T) tokens split
    their members over the same mesh dims, the table's vocabulary over
    others, and nothing else?"""
    if not is_dtensor(tokens) or tokens.device_mesh != table.device_mesh:
        return False
    for pt, pk in zip(table.placements, tokens.placements):
        if pt.is_shard(0) != pk.is_shard(0) or pk.is_partial() or \
                pt.is_partial() or pt.is_shard(2) or \
                (pk.is_shard() and not pk.is_shard(0)):
            return False
    return True


def _masked_lookup(table, tokens):
    """The indexed read of several members' rows on each rank's shard:
    its members' tokens that fall in its vocabulary slice read their
    rows, the others zeros, and the vocabulary's mesh dims hold partial
    sums (DTensor's own F.embedding rule for one member, here over a
    member dim; torch 2.11 has no rule for the indexed read's
    gradient)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    local = table.to_local()
    (_, n_vocab, _), (_, v0, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    idx = tokens.to_local().long() - v0
    ok = (idx >= 0) & (idx < n_vocab)
    k = torch.arange(local.shape[0], device=idx.device)
    rows = local[k[:, None, None], idx.where(ok, 0)] * ok[..., None]
    lay = [Shard(0) if p.is_shard(0) else Partial() if p.is_shard(1)
           else Replicate() for p in table.placements]
    shape = (*tokens.shape, table.shape[-1])
    return DTensor.from_local(rows, mesh, lay, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def head_init(gen, lead, vocab: int, d_model: int, dtype) -> dict:
    return {"head": dense_init(gen, lead, (vocab, d_model), dtype)}


def lm_logits(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """x (K, ..., d) -> logits (K, ..., V) against the (tied) table."""
    table = params["head"] if "head" in params else params["embed"]
    logits = mm(x, table.transpose(1, 2))
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return constrain(logits, *(None,) * (logits.dim() - 1), "model")
