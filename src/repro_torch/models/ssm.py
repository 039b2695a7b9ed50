"""State-space mixers over the member-stacked layout: Mamba's selective
scan (jamba) and RWKV6 (finch), its time-mix with data-dependent decay
and its channel-mix.

Params keep the JAX package's leaf names; every leaf has a leading
member axis K and activations are (K, B, T, d).  The recurrences go
through kernels/ops.ssm_scan and kernels/ops.wkv6 in apply, prefill and
decode alike (decode is a chunk of one token), with the K members folded
into the kernels' rows: one launch per layer (per 128-token Mamba piece)
covers every member and slot.  Decode and prefill update the cache
planes in place (see models/attention.py).

Per layer and slot the decode state is O(1) in sequence length:
  mamba: conv (K, B, conv_w-1, d_inner)  the last conv inputs
         ssm  (K, B, d_inner, d_state) f32  the selective-scan state
  rwkv6: shift (K, B, 1, d)  the last mixer input (token shift)
         wkv   (K, B, H, dh, dh) f32  the recurrent [key, value] state
(the channel-mix's own `cmix_shift` lives in models/transformer.py).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, member_view, mm

MAMBA_CHUNK = 128    # the JAX package's: one scan launch per piece
GROUPNORM_EPS = 1e-5  # the JAX package's _rwkv_groupnorm, not cfg.norm_eps


def _full(lead, shape, value: float, device) -> torch.Tensor:
    return torch.full((*lead, *shape), value, dtype=torch.float32,
                      device=device)


# ===========================================================================
# Mamba
# ===========================================================================

def mamba_dims(cfg: ModelConfig) -> Tuple[int, int]:
    d_inner = cfg.ssm.expand * cfg.d_model
    dt_rank = cfg.ssm.dt_rank or max(1, cfg.d_model // 16)
    return d_inner, dt_rank


def mamba_init(gen, lead, cfg: ModelConfig, dtype) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, dt_rank = mamba_dims(cfg)
    dev = gen.device
    A = torch.arange(1, s.d_state + 1, dtype=torch.float32, device=dev)
    return {
        # in_proj packs [x, z]
        "mamba_in": dense_init(gen, lead, (d, 2 * d_inner), dtype),
        "mamba_conv": dense_init(gen, lead, (s.conv_width, d_inner), dtype,
                                 scale=1.0 / math.sqrt(s.conv_width)),
        # x_proj packs [dt, B, C]
        "mamba_dt_x": dense_init(gen, lead, (d_inner, dt_rank + 2 * s.d_state),
                                 dtype),
        "mamba_dt_w": dense_init(gen, lead, (dt_rank, d_inner), dtype),
        "mamba_dt_b": _full(lead, (d_inner,), -4.6, dev),  # softplus: ~0.01
        "mamba_A_log": torch.log(A).expand(*lead, d_inner, s.d_state)
                            .contiguous(),
        "mamba_D": _full(lead, (d_inner,), 1.0, dev),
        "mamba_out": dense_init(gen, lead, (d_inner, d), dtype),
    }


def _mamba_conv_full(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv by shifted adds, x (K, B, T, di), w (K, W,
    di).  Accumulates in f32 (as decode does: both stay bit-aligned
    through the silu when params are bf16); -> f32."""
    W, T = w.shape[1], x.shape[2]
    xf, wf = x.float(), w.float()
    out = xf * member_view(wf[:, -1], xf)
    for i in range(1, W):
        shifted = F.pad(xf, (0, 0, i, 0))[:, :, :T]
        out = out + shifted * member_view(wf[:, -1 - i], xf)
    return out


def _mamba_inner(params, xz: torch.Tensor, cfg: ModelConfig,
                 state: torch.Tensor, valid: torch.Tensor = None
                 ) -> torch.Tensor:
    """The scan core over conv'd x, xz (K, B, T, di); state (K, B, di,
    Ns) f32 is read as h0 and left holding h_T.  -> y (K, B, T, di) f32.

    The sequence is walked in MAMBA_CHUNK pieces: each forms a = exp(dt
    A) and b = dt x B in f32, (K*B, CH, di, Ns) (the live set), runs one
    ops.ssm_scan launch on it carrying the state, and contracts the
    states with C.  valid (B, T) marks real positions; elsewhere dt is
    0, so the step is the identity (a = 1, b = 0) and the state passes
    through padding untouched."""
    s = cfg.ssm
    d_inner, dt_rank = mamba_dims(cfg)
    K, B, T, _ = xz.shape
    Ns = s.d_state
    proj = mm(xz, params["mamba_dt_x"])
    dt_lo = proj[..., :dt_rank]
    Bm = proj[..., dt_rank: dt_rank + Ns].float()
    Cm = proj[..., dt_rank + Ns:].float()
    dt = F.softplus(mm(dt_lo, params["mamba_dt_w"]).float()
                    + member_view(params["mamba_dt_b"], proj))  # (K,B,T,di)
    if valid is not None:
        dt = torch.where(valid[None, :, :, None], dt, 0.0)
    A = -torch.exp(params["mamba_A_log"])[:, None, None]    # (K,1,1,di,Ns)
    xf = xz.float()
    dtx = dt * xf
    ys = []
    for t0 in range(0, T, MAMBA_CHUNK):
        sl = slice(t0, min(t0 + MAMBA_CHUNK, T))
        a = torch.exp(dt[:, :, sl, :, None] * A)           # (K,B,CH,di,Ns)
        b = dtx[:, :, sl, :, None] * Bm[:, :, sl, None, :]
        CH = a.shape[2]
        hs = ops.ssm_scan(a.reshape(K * B, CH, d_inner, Ns),
                          b.reshape(K * B, CH, d_inner, Ns), state)
        ys.append(torch.einsum("nlds,nls->nld", hs,
                               Cm[:, :, sl].reshape(K * B, CH, Ns)))
    y = torch.cat(ys, 1).reshape(K, B, T, d_inner)
    return y + xf * member_view(params["mamba_D"], xf)


def _mamba_out(params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return mm(y.to(z.dtype) * F.silu(z), params["mamba_out"])


def mamba_apply(params: dict, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """x (K, B, T, d) from position 0 -> (K, B, T, d)."""
    K, B = x.shape[:2]
    d_inner, _ = mamba_dims(cfg)
    xz = mm(x, params["mamba_in"])
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    xs = F.silu(_mamba_conv_full(xs, params["mamba_conv"])).to(xs.dtype)
    state = torch.zeros(K, B, d_inner, cfg.ssm.d_state, dtype=torch.float32,
                        device=x.device)
    return _mamba_out(params, _mamba_inner(params, xs, cfg, state), z)


def mamba_cache_init(cfg: ModelConfig, lead, batch: int, dtype,
                     device) -> dict:
    s = cfg.ssm
    d_inner, _ = mamba_dims(cfg)
    return {
        "conv": torch.zeros(*lead, batch, s.conv_width - 1, d_inner,
                            dtype=dtype, device=device),
        "ssm": torch.zeros(*lead, batch, d_inner, s.d_state,
                           dtype=torch.float32, device=device),
    }


def mamba_decode(params: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig) -> torch.Tensor:
    """One token per row: x (K, B, 1, d); cache {"conv", "ssm"} views of
    one layer, advanced in place.  -> (K, B, 1, d)."""
    d_inner, _ = mamba_dims(cfg)
    xz = mm(x, params["mamba_in"])
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    window = torch.cat([cache["conv"].to(xs.dtype), xs], 2)   # (K,B,W,di)
    conv = torch.einsum("kbwd,kwd->kbd", window.float(),
                        params["mamba_conv"].float())
    xc = F.silu(conv)[:, :, None].to(xs.dtype)
    y = _mamba_inner(params, xc, cfg, cache["ssm"])
    cache["conv"].copy_(window[:, :, 1:])
    return _mamba_out(params, y, z)


def mamba_prefill(params: dict, x: torch.Tensor, cache: dict,
                  n_tok: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Chunk prefill: x (K, B, C, d); n_tok (B,) valid tokens per row.

    The conv window is seeded from the cached tail and the scan starts
    from the cached state with padded positions masked to identity
    steps, so the new state equals stepping mamba_decode over exactly
    the n_tok valid tokens.  New tails are cut at offset n_tok, so a row
    with n_tok == 0 is a bit-exact no-op.  -> (K, B, C, d); the cache
    advances in place."""
    C = x.shape[2]
    W = cfg.ssm.conv_width
    d_inner, _ = mamba_dims(cfg)
    xz = mm(x, params["mamba_in"])
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    ctx = torch.cat([cache["conv"].to(xs.dtype), xs], 2)    # (K,B,W-1+C,di)
    conv = _mamba_conv_full(ctx, params["mamba_conv"])[:, :, W - 1:]
    xc = F.silu(conv).to(xs.dtype)
    valid = (torch.arange(C, device=x.device)[None, :]
             < n_tok.long()[:, None])                       # (B, C)
    y = _mamba_inner(params, xc, cfg, cache["ssm"], valid)
    cache["conv"].copy_(tail_at(ctx, n_tok, W - 1))
    return _mamba_out(params, y, z)


# ===========================================================================
# RWKV6 (finch) — data-dependent per-channel decay
# ===========================================================================

def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    dh = cfg.ssm.rwkv_head_dim
    return cfg.d_model // dh, dh  # (n_heads, head_dim)


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


def tail_at(ctx: torch.Tensor, n_tok: torch.Tensor,
            width: int) -> torch.Tensor:
    """ctx (K, B, width+C, d) = [cached tail, chunk]: each row's new
    tail, ctx[:, b, n_tok[b]:n_tok[b] + width] -> (K, B, width, d).
    n_tok == 0 keeps the old tail."""
    B = ctx.shape[1]
    rows = torch.arange(B, device=ctx.device)[:, None]
    cols = n_tok.long()[:, None] + torch.arange(width, device=ctx.device)
    return ctx[:, rows, cols]


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
    cache["shift"].copy_(tail_at(ctx, n_tok, 1))
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
