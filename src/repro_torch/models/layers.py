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

from repro_torch.common.types import ModelConfig


def dense_init(gen: torch.Generator, lead: Sequence[int], shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) weights of per-layer `shape`, stacked
    under the `lead` axes (members, segment count); fan_in = shape[-2].

    The leaf is allocated in `dtype` and filled one (member, layer)
    slice at a time through one reused f32 buffer, so init holds at most
    one slice in f32 beside the weights (a full-width 7B model at K = 4
    fits on one 80 GB card)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(*lead, *shape, dtype=dtype, device=gen.device)
    buf = torch.empty(*shape, dtype=torch.float32, device=gen.device)
    for part in w.view(-1, *shape):
        torch.randn(*shape, generator=gen, out=buf)
        part.copy_(buf.mul_(std))
    return w


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-member matmul: x (K, ..., d) @ w (K, d, n) -> (K, ..., n)."""
    K = x.shape[0]
    out = torch.bmm(x.reshape(K, -1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def member_view(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(K, n) per-member vector -> broadcastable against x (K, ..., n)."""
    return w.reshape(w.shape[0], *([1] * (x.dim() - 2)), w.shape[-1])


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
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate x (..., seq, heads, head_dim) by positions (..., seq),
    where positions broadcasts against x's leading axes."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]          # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


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
    """tokens (...) shared by all members -> (K, ..., d)."""
    x = params["embed"][:, tokens.long()]
    if cfg.scale_embeddings:
        # the scale is cast to the embed dtype first, as the JAX package does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


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
    return logits
