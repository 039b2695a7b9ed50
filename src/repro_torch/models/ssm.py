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

Both kernels are forward-only, so apply(train=True) takes the training
route, the JAX package's own form of the recurrences: chunks in plain
PyTorch that autograd differentiates, each under torch.utils.checkpoint
(its graph rebuilt in the backward), carrying the state from chunk to
chunk (_mamba_chunked, _wkv_chunked).

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
from torch.utils.checkpoint import checkpoint

from repro_torch.common.sharding import constrain, is_dtensor
from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, member_view, mm,
                                      shift_seq)

MAMBA_CHUNK = 128    # the JAX package's: one scan launch per piece
RWKV_CHUNK = 32      # the JAX package's: the training route's pairwise
#                      decays are (N, L, L, H, dh) a chunk
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
    W = w.shape[1]
    xf, wf = x.float(), w.float()
    out = xf * member_view(wf[:, -1], xf)
    for i in range(1, W):
        out = out + shift_seq(xf, i) * member_view(wf[:, -1 - i], xf)
    return out


def _mamba_coeffs(params, xz: torch.Tensor, cfg: ModelConfig,
                  valid: torch.Tensor = None):
    """The scan's inputs from conv'd x, xz (K, B, T, di): dt and dt x
    (K, B, T, di), A (K, 1, 1, di, Ns), B and C (K, B, T, Ns), all f32,
    and x in f32.  valid (B, T) marks real positions; elsewhere dt is 0,
    so the step is the identity (a = 1, b = 0)."""
    Ns = cfg.ssm.d_state
    _, dt_rank = mamba_dims(cfg)
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
    return dt, dt * xf, A, Bm, Cm, xf


def _mamba_inner(params, xz: torch.Tensor, cfg: ModelConfig,
                 state: torch.Tensor, valid: torch.Tensor = None
                 ) -> torch.Tensor:
    """The scan core over conv'd x, xz (K, B, T, di); state (K, B, di,
    Ns) f32 is read as h0 and left holding h_T.  -> y (K, B, T, di) f32.

    The sequence is walked in MAMBA_CHUNK pieces: each forms a = exp(dt
    A) and b = dt x B in f32, (K*B, CH, di, Ns) (the live set), runs one
    ops.ssm_scan launch on it carrying the state, and contracts the
    states with C.  valid (B, T): see _mamba_coeffs; the state passes
    through padding untouched."""
    d_inner, _ = mamba_dims(cfg)
    K, B, T, _ = xz.shape
    Ns = cfg.ssm.d_state
    dt, dtx, A, Bm, Cm, xf = _mamba_coeffs(params, xz, cfg, valid)
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


def _mamba_state(h, dt, dtx, A, Bm, t: int):
    """Step t of a chunk's state: h_t = exp(dt_t A) h_{t-1} + dt_t x_t
    B_t."""
    return torch.exp(dt[:, :, t, :, None] * A) * h \
        + dtx[:, :, t, :, None] * Bm[:, :, t, None, :]


def _mamba_step(h, dt, dtx, A, Bm, Cm, t: int):
    """Step t of a chunk -> (y_t = <h_t, C_t>, h_t)."""
    h = _mamba_state(h, dt, dtx, A, Bm, t)
    return (h * Cm[:, :, t, None, :]).sum(-1), h


def _mamba_chunk(h, dt, dtx, A, Bm, Cm):
    """One chunk of the training route: h (K, B, di, Ns) the carried
    state, dt and dtx (K, B, CH, di), A (K, 1, di, Ns), Bm and Cm (K, B,
    CH, Ns).  A step loop, each state contracted with C_t at once,
    rather than a log-depth (Hillis-Steele) scan of the pairs (a, b):
    its backward keeps one state and one a_t a step (two chunk-sized
    tensors, 1.1 GB a 64-token chunk at jamba's width, K 2 x B 8), where
    the scan keeps two a level, log2(CH) levels.  -> (y (K, B, CH, di),
    h_CH)."""
    ys = []
    for t in range(dt.shape[2]):
        y, h = _mamba_step(h, dt, dtx, A, Bm, Cm, t)
        ys.append(y)
    return torch.stack(ys, 2), h


class _CountedChunk(torch.autograd.Function):
    """The dry-run's form of checkpoint(_mamba_chunk) on plain fake
    tensors: the CH steps are alike, so a step is run and counted for
    all that are like it (cost_analysis.repeated), as the reference's
    HLO runs one scan body; a step loop of 4,096 tokens a layer is
    millions of ops otherwise.  Two forms: the first step reads the
    chunk's state as it comes (a zero state may be a broadcast), the
    later ones a full state.  Its ops are the checkpointed loop's: the
    forward's steps and the stack of their outputs; in the backward the
    steps' recompute (which stops, as checkpoint's does, once the last
    step's state is back: its output is not formed again), their
    gradients (the last step's from the chunk's own state gradient, if
    any, the others' from a full one, as the next step gives it), a
    select's scatter for each sliced input, and the CH - 1 sums of the
    gradients of the inputs every step reads: the loop's FLOPs and
    bytes.  Not its peak: the loop's recompute holds CH steps' saved
    tensors, this one step's.  The values are not the loop's."""

    @staticmethod
    def forward(ctx, h, dt, dtx, A, Bm, Cm):
        from repro_torch.launch.cost_analysis import repeated
        ctx.set_materialize_grads(False)
        n = dt.shape[2]
        ctx.save_for_backward(h, dt, dtx, A, Bm, Cm)
        y, h = _mamba_step(h, dt, dtx, A, Bm, Cm, 0)
        with repeated(n - 1):
            _, h = _mamba_step(h, dt, dtx, A, Bm, Cm, 0)
        with repeated(n):
            y = torch.stack([y], 2)
        with repeated(0):           # the n outputs, already counted
            y = torch.cat([y] * n, 2)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        from repro_torch.launch.cost_analysis import repeated
        saved = ctx.saved_tensors
        n = saved[1].shape[2]
        xs = [x.detach().requires_grad_(need)
              for x, need in zip(saved, ctx.needs_input_grad)]
        g_y = gy[:, :, 0]
        with torch.enable_grad():
            # the recompute: the first step, the full ones, the last
            # step's state
            with repeated(1 if n > 1 else 0):
                y0, h0 = _mamba_step(*xs, 0)
            later = [h0.detach().requires_grad_()] + xs[1:]
            with repeated(max(n - 2, 0)):
                y, h = _mamba_step(*later, 0)
            _mamba_state(*(later if n > 1 else xs)[:5], 0)
            with repeated(0):
                full = torch.empty_like(h)

            def grad(outs, g_outs, inputs, times, keep=True):
                want = [x for x in inputs if x.requires_grad]
                if gh is None and g_outs[1] is None:
                    outs, g_outs = outs[:1], g_outs[:1]
                with repeated(times):
                    got = iter(torch.autograd.grad(
                        outs, want, g_outs, retain_graph=keep,
                        allow_unused=True))
                return [next(got) if x.requires_grad else None
                        for x in inputs]

            if n > 1:
                grad((y, h), (g_y, full), later, n - 2)
                grad((y, h), (g_y, gh), later, 1)       # the last step
                grads = grad((y0, h0), (g_y, full), xs, 1, keep=False)
            else:
                grads = grad((y0, h0), (g_y, gh), xs, 1, keep=False)
        with repeated(n - 1):       # every step's share of dt .. Cm
            grads[1:] = [g if g is None else g + g.detach()
                         for g in grads[1:]]
        return tuple(grads)


def _mamba_chunked(params, xz: torch.Tensor, cfg: ModelConfig,
                   h: torch.Tensor):
    """The training route of the scan core, the JAX package's
    _mamba_inner: MAMBA_CHUNK pieces, each under torch.utils.checkpoint,
    never ops.ssm_scan.  xz (K, B, T, di) conv'd x, h (K, B, di, Ns) f32
    the initial state.  -> (y (K, B, T, di) f32, h_T)."""
    dt, dtx, A, Bm, Cm, xf = _mamba_coeffs(params, xz, cfg)
    y, h = _mamba_scan(h, dt, dtx, A[:, 0], Bm, Cm)
    return y + xf * member_view(params["mamba_D"], xf), h


def _mamba_pieces(h, dt, dtx, A, Bm, Cm):
    """The chunks of _mamba_chunked, the state carried -> (y, h_T).  On
    fake tensors (the dry-run) a chunk's steps are traced one for all
    (_CountedChunk)."""
    ys = []
    for t0 in range(0, dt.shape[2], MAMBA_CHUNK):
        sl = slice(t0, t0 + MAMBA_CHUNK)
        args = (h, dt[:, :, sl], dtx[:, :, sl], A, Bm[:, :, sl],
                Cm[:, :, sl])
        if _fake(h):
            y, h = _CountedChunk.apply(*args)
        else:
            y, h = checkpoint(_mamba_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        ys.append(y)
    return torch.cat(ys, 2), h


def _mamba_scan(h, dt, dtx, A, Bm, Cm):
    """_mamba_pieces; over DTensors (the dry-run's training cells) on
    each rank's shard, where dt's members, rows and channels may be
    sharded but not its time: every (member, row, channel) runs alone,
    so the steps need no collective (the inputs are laid out as dt is
    first), and they are plain tensors' ops, not DTensor's."""
    if not is_dtensor(dt) or any(
            p.is_partial() or (p.is_shard() and p.dim == 2)
            for p in dt.placements):
        return _mamba_pieces(h, dt, dtx, A, Bm, Cm)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, lay = dt.device_mesh, dt.placements

    def local(x, dims):
        """x's shard laid out as dt's: dims maps dt's dim to x's.  Its
        gradient is a partial sum over the ranks that split a dim of
        dt's that x lacks (B and C over the channels)."""
        to = [Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
              else Replicate() for p in lay]
        return x.redistribute(mesh, to).to_local(grad_placements=[
            Partial() if p.is_shard() and p.dim not in dims else q
            for p, q in zip(lay, to)])

    y, h_t = _mamba_pieces(local(h, {0: 0, 1: 1, 3: 2}),
                           local(dt, {0: 0, 1: 1, 3: 3}),
                           local(dtx, {0: 0, 1: 1, 3: 3}),
                           local(A, {0: 0, 3: 2}),
                           local(Bm, {0: 0, 1: 1}), local(Cm, {0: 0, 1: 1}))

    def whole(x, like, dims):
        return DTensor.from_local(x, mesh, [
            Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
            else Replicate() for p in lay], run_check=False,
            shape=like.shape, stride=torch.empty(like.shape,
                                                 device="meta").stride())
    return (whole(y, dt, {0: 0, 1: 1, 3: 3}),
            whole(h_t, h, {0: 0, 1: 1, 3: 2}))


def _fake(x: torch.Tensor) -> bool:
    """A fake tensor (a DTensor's local shard included): the dry-run."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x._local_tensor if is_dtensor(x) else x, FakeTensor)


def _mamba_out(params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return mm(y.to(z.dtype) * F.silu(z), params["mamba_out"])


def mamba_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                train: bool = False) -> torch.Tensor:
    """x (K, B, T, d) from position 0 -> (K, B, T, d).  train=True takes
    the training route (_mamba_chunked), else ops.ssm_scan."""
    K, B = x.shape[:2]
    d_inner, _ = mamba_dims(cfg)
    xz = mm(x, params["mamba_in"])
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    xs = constrain(xs, None, None, None, "model")
    xs = F.silu(_mamba_conv_full(xs, params["mamba_conv"])).to(xs.dtype)
    # new_zeros: over a DTensor (the dry-run's) the state is one too
    state = x.new_zeros(K, B, d_inner, cfg.ssm.d_state, dtype=torch.float32)
    if train:
        y, _ = _mamba_chunked(params, xs, cfg, state)
    else:
        y = _mamba_inner(params, xs, cfg, state)
    return _mamba_out(params, constrain(y, None, None, None, "model"), z)


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
    r, k, v, g = (constrain(mm(xi, params[w]), None, "batch", None, "model")
                  for xi, w in ((xr, "rwkv_r"), (xk, "rwkv_k"),
                                (xv, "rwkv_v"), (xg, "rwkv_g")))
    g = F.silu(g)
    # decay in log space: log w = -exp(base + lora)
    dec = member_view(params["rwkv_decay_base"], xf) + mm(
        torch.tanh(mm(xw.float(), params["rwkv_decay_lora_a"])),
        params["rwkv_decay_lora_b"])
    log_w = -torch.exp(dec.clamp(-20.0, 4.0))
    return r, k, v, g, constrain(log_w, None, "batch", None, "model")


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


def _wkv_chunk(S, rb, kb, vb, lw, u):
    """One chunk of the training route: S (N, H, dh, dh) the carried
    [key, value] state; rb, kb, vb, lw (N, L, H, dh); u (N, 1, H, dh).
    -> (y (N, L, H, dh), S_L).

    Every decay is the exponential of a sum of log w over the tokens
    between two positions, an exponent <= 0.  The pairwise decays of
    token j to token t > j, exp(la_prev[t] - la[j]), are masked to j < t
    BEFORE the exponential: on the masked pairs the exponent is >= 0 and
    overflows once a chunk's decays pass about 88, and the JAX package's
    where(tri, exp(ld), 0) then gives a NaN gradient (0 * inf) though its
    value is right (ROADMAP queue 3)."""
    L = rb.shape[1]
    la = torch.cumsum(lw, 1)                  # inclusive sums of log w
    la_prev = la - lw                         # exclusive
    r_in = rb * torch.exp(la_prev)            # r decayed to the start
    k_out = kb * torch.exp(la[:, -1:] - la)   # k decayed to the end
    tri = torch.ones(L, L, dtype=torch.bool, device=rb.device).tril(-1)
    ld = la_prev[:, :, None] - la[:, None]    # (N, L, L, H, dh)
    dec = torch.exp(torch.where(tri[None, :, :, None, None], ld,
                                float("-inf")))
    scores = (rb[:, :, None] * kb[:, None] * dec).sum(-1)   # (N, L, L, H)
    y = torch.einsum("nlmh,nmhd->nlhd", scores, vb)
    y = y + torch.einsum("nlhk,nhkv->nlhv", r_in, S)        # cross-chunk
    y = y + (rb * kb * u).sum(-1, keepdim=True) * vb        # the bonus
    S = S * torch.exp(la[:, -1])[..., None] \
        + torch.einsum("nlhk,nlhv->nhkv", k_out, vb)
    return y, S


def _wkv_chunked(r, k, v, log_w, u, s0):
    """The wkv recurrence's training route, the JAX package's
    _wkv_chunked: RWKV_CHUNK-token chunks (the last one shorter), each
    under torch.utils.checkpoint, never ops.wkv6.

    r, k, v, log_w (N, T, H, dh) f32 with N = K*B rows folding K
    members; u (K, H, dh), row n reading member n // (N / K)'s, or (H,
    dh); s0 (N, H, dh, dh).  -> (y (N, T, H, dh), s_T)."""
    N, T, H, dh = r.shape
    u = u.reshape(-1, H, dh)
    u = u.repeat_interleave(N // u.shape[0], 0)[:, None]   # (N, 1, H, dh)
    S, ys = s0, []
    for t0 in range(0, T, RWKV_CHUNK):
        sl = slice(t0, t0 + RWKV_CHUNK)
        y, S = checkpoint(_wkv_chunk, S, r[:, sl], k[:, sl], v[:, sl],
                          log_w[:, sl], u, use_reentrant=False,
                          preserve_rng_state=False)
        ys.append(y)
    return torch.cat(ys, 1), S


def _wkv_chunked_from_zero(r, k, v, log_w, u) -> torch.Tensor:
    """_wkv_chunked's y from a zero state.  Over DTensors whose rows
    (members) and heads are sharded (the dry-run's training cells), on
    each rank's shard: every row and head runs alone, and DTensor's view
    rule (torch 2.11) refuses the chunk products' fold of the two."""
    N, _, H, dh = r.shape
    if not is_dtensor(r) or not _rows_heads_layout(r, k, v, log_w, u=u):
        s0 = torch.zeros(N, H, dh, dh, dtype=torch.float32, device=r.device)
        return _wkv_chunked(r, k, v, log_w, u, s0)[0]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    loc = [t.to_local() for t in (r, k, v, log_w)]
    n, _, h, _ = loc[0].shape
    u = u.redistribute(u.device_mesh, [   # its heads as r's: a slice
        Shard(1) if p.is_shard(2) else Shard(0) if p.is_shard(0)
        else Replicate() for p in r.placements])
    y, _ = _wkv_chunked(*loc, u.to_local(), torch.zeros(
        n, h, dh, dh, dtype=torch.float32, device=loc[0].device))
    return DTensor.from_local(y, r.device_mesh, r.placements, run_check=False,
                              shape=r.shape, stride=r.stride())


def _rows_heads_layout(*ts, u) -> bool:
    """Are the (N, T, H, dh) tensors `ts` laid out alike, sharded over
    rows or heads only, and u (K, H, dh) over the same members (the
    rows' mesh dims), its heads as theirs or whole?"""
    lay = ts[0].placements
    if any(t.placements != lay for t in ts) or not is_dtensor(u):
        return False
    for p, q in zip(lay, u.placements):
        ok = (q.is_replicate() and not p.is_shard(0)) if not q.is_shard() \
            else (p.is_shard(0) and q.is_shard(0)) or \
            (p.is_shard(2) and q.is_shard(1))
        if not ok or not (p.is_replicate() or p.is_shard(0)
                          or p.is_shard(2)):
            return False
    return True


def _rwkv_out(params, y: torch.Tensor, g: torch.Tensor, H: int, dh: int):
    y = _rwkv_groupnorm(y, params["rwkv_ln_scale"], H, dh)
    return mm(y.to(g.dtype) * g, params["rwkv_o"])


def rwkv_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
               train: bool = False) -> torch.Tensor:
    """x (K, B, T, d) from position 0 -> (K, B, T, d).  train=True takes
    the training route (_wkv_chunked), else ops.wkv6."""
    K, B, T, d = x.shape
    H, dh = rwkv_dims(cfg)
    x_prev = shift_seq(x, 1)
    r, k, v, g, log_w = _rwkv_proj(params, x, x_prev)
    if train:
        def heads(t):
            return t.float().reshape(K * B, T, H, dh)
        y = _wkv_chunked_from_zero(heads(r), heads(k), heads(v),
                                   heads(log_w), params["rwkv_first"])
        y = y.reshape(K, B, T, d)
    else:
        state = x.new_zeros(K, B, H, dh, dh, dtype=torch.float32)
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
