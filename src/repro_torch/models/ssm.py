"""RWKV6 (finch): the time-mix with data-dependent decay and the
channel-mix, over the member-stacked layout.

Params keep the JAX package's leaf names; every leaf has a leading
member axis K and activations are (K, B, T, d).  The wkv recurrence goes
through kernels/ops.wkv6 in apply, prefill and decode alike (decode is a
chunk of one token), with the K members folded into the kernel's rows:
one launch per layer covers every member, slot and head.  Decode and
prefill update the cache planes in place (see models/attention.py).

Per layer and slot the decode state is O(1) in sequence length:
  shift (K, B, 1, d)  the last mixer input (token shift)
  wkv   (K, B, H, dh, dh) f32  the recurrent [key, value] state
(the channel-mix's own `cmix_shift` lives in models/transformer.py).
Mamba, the other state-space mixer of the JAX package's ssm module,
comes with a later slice.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, member_view, mm

GROUPNORM_EPS = 1e-5  # the JAX package's _rwkv_groupnorm, not cfg.norm_eps


def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    dh = cfg.ssm.rwkv_head_dim
    return cfg.d_model // dh, dh  # (n_heads, head_dim)


def _full(lead, shape, value: float, device) -> torch.Tensor:
    return torch.full((*lead, *shape), value, dtype=torch.float32,
                      device=device)


def rwkv_init(gen, lead, cfg: ModelConfig, dtype) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    H, dh = rwkv_dims(cfg)
    f32 = torch.float32
    dev = gen.device
    return {
        # token-shift base mix for (r,k,v,g,w) + data-dependent LoRA
        "rwkv_mix_base": _full(lead, (5, d), 0.5, dev),
        "rwkv_mix_lora_a": dense_init(gen, lead, (d, s.rwkv_lora_mix), f32),
        "rwkv_mix_lora_b": dense_init(gen, lead, (s.rwkv_lora_mix, 5 * d),
                                      f32, scale=0.01),
        "rwkv_r": dense_init(gen, lead, (d, d), dtype),
        "rwkv_k": dense_init(gen, lead, (d, d), dtype),
        "rwkv_v": dense_init(gen, lead, (d, d), dtype),
        "rwkv_g": dense_init(gen, lead, (d, d), dtype),
        "rwkv_o": dense_init(gen, lead, (d, d), dtype),
        # decay: per-channel base + data-dependent LoRA (the v6 novelty)
        "rwkv_decay_base": _full(lead, (d,), -6.0, dev),
        "rwkv_decay_lora_a": dense_init(gen, lead, (d, s.rwkv_lora_decay),
                                        f32),
        "rwkv_decay_lora_b": dense_init(gen, lead, (s.rwkv_lora_decay, d),
                                        f32, scale=0.01),
        "rwkv_first": dense_init(gen, lead, (H, dh), f32, scale=0.5),
        "rwkv_ln_scale": _full(lead, (d,), 1.0, dev),
    }


def _rwkv_proj(params, x: torch.Tensor, x_prev: torch.Tensor):
    """Token shift + projections.  x, x_prev (K, B, T, d), x_prev the
    shifted input.  -> r, k, v, g in x's dtype and log_w (K, B, T, d)
    f32, strictly < 0."""
    K, B, T, d = x.shape
    xf = x.float()
    # data-dependent mix: mix = base + lora(x), f32
    lora = mm(torch.tanh(mm(xf, params["rwkv_mix_lora_a"])),
              params["rwkv_mix_lora_b"]).reshape(K, B, T, 5, d)
    mix = params["rwkv_mix_base"][:, None, None] + lora   # (K, B, T, 5, d)
    xf5 = xf[..., None, :]
    mixed = xf5 + (x_prev.float()[..., None, :] - xf5) * mix
    xr, xk, xv, xg, xw = (mixed[..., i, :].to(x.dtype) for i in range(5))
    r = mm(xr, params["rwkv_r"])
    k = mm(xk, params["rwkv_k"])
    v = mm(xv, params["rwkv_v"])
    g = F.silu(mm(xg, params["rwkv_g"]))
    # decay in log space: log w = -exp(base + lora)
    dec = member_view(params["rwkv_decay_base"], xf) + mm(
        torch.tanh(mm(xw.float(), params["rwkv_decay_lora_a"])),
        params["rwkv_decay_lora_b"])
    log_w = -torch.exp(dec.clamp(-20.0, 4.0))
    return r, k, v, g, log_w


def _rwkv_groupnorm(y: torch.Tensor, scale: torch.Tensor, H: int,
                    dh: int) -> torch.Tensor:
    """Per-head layer norm of y (K, B, T, H*dh) -> f32 * scale."""
    K, B, T = y.shape[:3]
    yf = y.reshape(K, B, T, H, dh).float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yf = (yf - mu) * torch.rsqrt(var + GROUPNORM_EPS)
    yf = yf.reshape(K, B, T, H * dh)
    return yf * member_view(scale, yf)


def _wkv(params, r, k, v, log_w, state: torch.Tensor, H: int, dh: int):
    """The recurrence over (K, B, T, d) projections through ops.wkv6,
    the K members folded into its rows; state (K, B, H, dh, dh) is
    updated in place.  -> y (K, B, T, d) f32."""
    K, B, T, d = r.shape

    def heads(t):
        return t.float().reshape(K * B, T, H, dh).contiguous()

    y = ops.wkv6(heads(r), heads(k), heads(v), heads(log_w),
                 params["rwkv_first"].contiguous(), state)
    return y.reshape(K, B, T, d)


def _rwkv_out(params, y: torch.Tensor, g: torch.Tensor, H: int, dh: int):
    y = _rwkv_groupnorm(y, params["rwkv_ln_scale"], H, dh)
    return mm(y.to(g.dtype) * g, params["rwkv_o"])


def rwkv_apply(params: dict, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x (K, B, T, d) from position 0 -> (K, B, T, d)."""
    K, B, T, d = x.shape
    H, dh = rwkv_dims(cfg)
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :, :T]
    r, k, v, g, log_w = _rwkv_proj(params, x, x_prev)
    state = torch.zeros(K, B, H, dh, dh, dtype=torch.float32,
                        device=x.device)
    y = _wkv(params, r, k, v, log_w, state, H, dh)
    return _rwkv_out(params, y, g, H, dh)


def rwkv_cache_init(cfg: ModelConfig, lead, batch: int, dtype,
                    device) -> dict:
    H, dh = rwkv_dims(cfg)
    return {
        "shift": torch.zeros(*lead, batch, 1, cfg.d_model, dtype=dtype,
                             device=device),
        "wkv": torch.zeros(*lead, batch, H, dh, dh, dtype=torch.float32,
                           device=device),
    }


def rwkv_decode(params: dict, x: torch.Tensor, cache: dict,
                cfg: ModelConfig) -> torch.Tensor:
    """One token per row: x (K, B, 1, d); cache {"shift", "wkv"} views
    of one layer, advanced in place.  -> (K, B, 1, d)."""
    H, dh = rwkv_dims(cfg)
    r, k, v, g, log_w = _rwkv_proj(params, x, cache["shift"].to(x.dtype))
    y = _wkv(params, r, k, v, log_w, cache["wkv"], H, dh)
    cache["shift"].copy_(x)
    return _rwkv_out(params, y, g, H, dh)


def shift_at(ctx: torch.Tensor, n_tok: torch.Tensor) -> torch.Tensor:
    """ctx (K, B, C+1, d) = [cached tail, chunk]: each row's new tail,
    ctx[:, b, n_tok[b]] -> (K, B, 1, d).  n_tok == 0 keeps the old
    tail."""
    B = ctx.shape[1]
    rows = torch.arange(B, device=ctx.device)
    return ctx[:, rows, n_tok.long()][:, :, None]


def rwkv_prefill(params: dict, x: torch.Tensor, cache: dict,
                 n_tok: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Chunk prefill: x (K, B, C, d); n_tok (B,) valid tokens per row.

    The token shift is seeded from the cached tail; padded positions are
    masked to state no-ops (k -> 0 kills the input term, log_w -> 0 is
    decay 1), so the new wkv state equals stepping rwkv_decode over
    exactly the n_tok valid tokens, and a row with n_tok == 0 is a
    bit-exact no-op.  -> (K, B, C, d); the cache advances in place."""
    K, B, C, d = x.shape
    H, dh = rwkv_dims(cfg)
    ctx = torch.cat([cache["shift"].to(x.dtype), x], 2)
    r, k, v, g, log_w = _rwkv_proj(params, x, ctx[:, :, :C])
    valid = (torch.arange(C, device=x.device)[None, :]
             < n_tok.long()[:, None])[None, :, :, None]       # (1, B, C, 1)
    k = torch.where(valid, k, torch.zeros((), dtype=k.dtype,
                                          device=k.device))
    log_w = torch.where(valid, log_w, 0.0)
    y = _wkv(params, r, k, v, log_w, cache["wkv"], H, dh)
    cache["shift"].copy_(shift_at(ctx, n_tok))
    return _rwkv_out(params, y, g, H, dh)


# --- rwkv channel-mix (its FFN flavor) -------------------------------------

def cmix_init(gen, lead, cfg: ModelConfig, d_ff: int, dtype) -> dict:
    d = cfg.d_model
    return {
        "cmix_mix": _full(lead, (d,), 0.5, gen.device),
        "cmix_k": dense_init(gen, lead, (d, d_ff), dtype),
        "cmix_v": dense_init(gen, lead, (d_ff, d), dtype),
    }


def cmix_apply(params: dict, x: torch.Tensor,
               x_prev: torch.Tensor) -> torch.Tensor:
    """x, x_prev (K, B, T, d), x_prev the shifted input -> (K, B, T, d)."""
    xf = x.float()
    xk = xf + (x_prev.float() - xf) * member_view(params["cmix_mix"], xf)
    h = torch.square(F.relu(mm(xk.to(x.dtype), params["cmix_k"])))
    return mm(h, params["cmix_v"])
