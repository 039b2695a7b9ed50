"""Transformer LM assembly for the serving path: pattern-driven blocks
over the member-stacked params.  A block is a pre-norm mixer, attention
(GQA, ring or paged), Mamba or rwkv6's time-mix (models/ssm.py), then a
pre-norm FFN: a dense MLP, a MoE (models/moe.py) or rwkv6's channel-mix.

Params keep the JAX package's tree: {"embed", ["head"], "final_norm",
"segments": [per-segment dict of "slot_<i>" blocks]}, every leaf with a
leading member axis K and segment leaves with the segment's `count`
axis next, (K, count, ...).  The JAX package scans each segment over
`count`; here it is a Python loop over the count axis, and the K members
run batched inside every op.

Entry points
  init(cfg, seed, device, members)          -> stacked params
  apply(params, cfg, tokens)                -> (logits (K,B,T,V), aux (K,))
  init_slot_cache(cfg, batch, max_seq, ...) -> slot-addressable cache
  decode_step_slots / decode_step_paged     -> (logits (K,B,1,V), cache)
  prefill_slots / prefill_step_paged        -> (last logits (K,B,V), cache)

Caches are updated in place (see models/attention.py and
models/ssm.py); the returned cache dict shares every plane with the one
passed in and carries the advanced `idx`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (embed_init, embed_lookup, head_init,
                                       lm_logits, mlp_apply, mlp_init,
                                       rmsnorm)


# (mixer, ffn) pairs of the ported layers
_PORTED = {("attn", "dense"), ("attn_local", "dense"), ("rwkv", "rwkv_cmix"),
           ("mamba", "dense"), ("mamba", "moe"), ("attn", "moe")}


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.enc_dec:
        raise NotImplementedError("enc-dec models (whisper) are not ported "
                                  "yet; they come with a later slice")
    for _, specs in cfg.segments():
        for s in specs:
            if (s.mixer, s.ffn) not in _PORTED:
                raise NotImplementedError(f"layer {s} is not ported yet")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _rmsnorm_init(lead, d, device) -> dict:
    return {"norm_scale": torch.ones(*lead, d, dtype=torch.float32,
                                     device=device)}


def init(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
         members: int = 1) -> dict:
    """Member-stacked params, torch-seeded: the names, shapes and init
    scales of the JAX package's transformer.init, stacked over `members`
    (the numbers differ: torch's generator is not jax.random)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    dtype = torch_dtype(cfg.dtype)
    K = (members,)
    params: Dict[str, Any] = {}
    params.update(embed_init(gen, K, cfg.vocab_size, cfg.d_model, dtype))
    if not cfg.tie_embeddings:
        params.update(head_init(gen, K, cfg.vocab_size, cfg.d_model, dtype))
    params["final_norm"] = _rmsnorm_init(K, cfg.d_model, dev)
    params["segments"] = []
    for count, specs in cfg.segments():
        lead = (members, count)
        seg = {}
        for i, spec in enumerate(specs):
            p = {"norm_mix": _rmsnorm_init(lead, cfg.d_model, dev)}
            if spec.mixer == "rwkv":
                p["rwkv"] = ssm.rwkv_init(gen, lead, cfg, dtype)
            elif spec.mixer == "mamba":
                p["mamba"] = ssm.mamba_init(gen, lead, cfg, dtype)
            else:
                p["attn"] = attn.attn_init(gen, lead, cfg, cfg.attn, dtype)
            p["norm_ffn"] = _rmsnorm_init(lead, cfg.d_model, dev)
            if spec.ffn == "rwkv_cmix":
                p["cmix"] = ssm.cmix_init(gen, lead, cfg, cfg.ffn.d_ff,
                                          dtype)
            elif spec.ffn == "moe":
                p["moe"] = moe.moe_init(gen, lead, cfg.d_model, cfg.ffn,
                                        dtype)
            else:
                p["mlp"] = mlp_init(gen, lead, cfg.d_model, cfg.ffn.d_ff,
                                    cfg.ffn.mlp_type, dtype)
            seg[f"slot_{i}"] = p
        params["segments"].append(seg)
    return params


def _layer(tree, c: int):
    """Slice layer c out of a (K, count, ...) segment subtree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, c) for k, v in tree.items()}
    return tree[:, c]


def _mixer_window(cfg: ModelConfig, spec: LayerSpec) -> Tuple[int, float]:
    if spec.mixer == "attn":
        return cfg.attn.window, cfg.attn.rope_theta
    return cfg.local_window, cfg.local_rope_theta


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _moe(p, cfg: ModelConfig, h: torch.Tensor, per_row: bool):
    """The MoE FFN over h (K, B, S, d), every member routing its own
    tokens with one capacity per pool: each row's S tokens (per_row, as
    the JAX package's row-vmapped prefill and contiguous decode see
    them) or all B*S tokens of the call (apply, paged decode).
    -> (out (K, B, S, d), aux (K,) summed over the pools)."""
    K, B, S, d = h.shape
    y, aux = moe.moe_apply(p["moe"], h if per_row else
                           h.reshape(K, 1, B * S, d), cfg.ffn)
    return y.reshape(K, B, S, d), aux.sum(1)


def apply(params, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens (B, T) -> (logits (K, B, T, V), aux): aux is the MoE
    layers' summed load-balance loss per member, (K,), or 0.0 for a
    model without MoE, as the JAX package's apply returns it."""
    _check_supported(cfg)
    x = embed_lookup(params, tokens, cfg)
    B, T = tokens.shape
    pos = torch.arange(T, device=x.device).expand(B, T)
    aux = 0.0
    for seg, (count, specs) in zip(params["segments"], cfg.segments()):
        for c in range(count):
            for i, spec in enumerate(specs):
                p = _layer(seg[f"slot_{i}"], c)
                h_in = rmsnorm(p["norm_mix"], x, cfg.norm_eps)
                if spec.mixer == "rwkv":
                    x = x + ssm.rwkv_apply(p["rwkv"], h_in, cfg)
                elif spec.mixer == "mamba":
                    x = x + ssm.mamba_apply(p["mamba"], h_in, cfg)
                else:
                    window, theta = _mixer_window(cfg, spec)
                    x = x + attn.gqa_apply(p["attn"], h_in, cfg.attn, cfg,
                                           pos, window, theta)
                h_f = rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
                if spec.ffn == "rwkv_cmix":
                    x_prev = F.pad(h_f, (0, 0, 1, 0))[:, :, :T]
                    x = x + ssm.cmix_apply(p["cmix"], h_f, x_prev)
                elif spec.ffn == "moe":
                    h, a = _moe(p, cfg, h_f, per_row=False)
                    x, aux = x + h, aux + a
                else:
                    x = x + mlp_apply(p["mlp"], h_f, cfg.ffn.mlp_type)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def layer_pages(cfg: ModelConfig, spec: LayerSpec, max_seq: int) -> bool:
    """Does this layer page its positional cache under paged serving?
    Full-attention layers (window 0 or >= max_seq) hold O(max_seq) per
    slot, which is what paging fixes; ring-bounded sliding-window layers
    keep their per-slot rings."""
    if spec.mixer == "attn":
        return cfg.attn.window <= 0 or cfg.attn.window >= max_seq
    if spec.mixer == "attn_local":
        return cfg.local_window <= 0 or cfg.local_window >= max_seq
    return False


def init_slot_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    page_size: int = 0, n_pages: int = 0, members: int = 1,
                    device: DeviceLike = None) -> dict:
    """Slot-addressable decode cache for `members` stacked members.

      idx            (K, B) int32           per-slot position
      ring planes    (K, count, B, S, Hkv, dh)
      paged planes   (K, count, n_pages, page_size, Hkv, dh)
      page_table     (K, B, ceil(max_seq / page_size)) int32, all
                     sentinel (n_pages = unallocated)
      recurrent      mamba "conv" (K, count, B, conv_w-1, d_inner), "ssm"
      planes         (K, count, B, d_inner, d_state) f32; rwkv "shift"
                     (K, count, B, 1, d), "wkv" (K, count, B, H, dh, dh)
                     f32; channel-mix "cmix_shift" (K, count, B, 1, d)

    With page_size > 0 the full-attention layers (layer_pages) get the
    shared paged pool; the other layers keep per-slot planes (a model
    with no full-attention layer, rwkv6, pages nothing and keeps only
    the page table)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    segments = []
    for count, specs in cfg.segments():
        lead = (members, count)
        seg = {}
        for i, spec in enumerate(specs):
            window, _ = _mixer_window(cfg, spec)
            if spec.mixer == "rwkv":
                c = ssm.rwkv_cache_init(cfg, lead, batch, dtype, dev)
            elif spec.mixer == "mamba":
                c = ssm.mamba_cache_init(cfg, lead, batch, dtype, dev)
            elif page_size > 0 and layer_pages(cfg, spec, max_seq):
                c = attn.gqa_paged_cache_init(cfg.attn, lead, n_pages,
                                              page_size, dtype, dev)
            else:
                c = attn.gqa_cache_init(cfg.attn, lead, batch, max_seq,
                                        window, dtype, dev)
            if spec.ffn == "rwkv_cmix":
                c["cmix_shift"] = torch.zeros(*lead, batch, 1, cfg.d_model,
                                              dtype=dtype, device=dev)
            seg[f"slot_{i}"] = c
        segments.append(seg)
    cache = {"idx": torch.zeros((members, batch), dtype=torch.int32,
                                device=dev),
             "segments": segments}
    if page_size > 0:
        P = -(-max_seq // page_size)
        cache["page_table"] = torch.full((members, batch, P), n_pages,
                                         dtype=torch.int32, device=dev)
    return cache


def global_table(table: torch.Tensor, c: int, count: int,
                 n_pages: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, B, P) per-member page ids -> (write, read) ids into the layer's
    plane with members and layers folded into the page axis,
    (K*count*n_pages, ...): member k's layer c pages start at
    (k*count + c)*n_pages.  Unallocated entries map, in the write table,
    to the folded page count (a sentinel: the write drops) and, in the
    read table, to the last page of member k's own layer c, which is
    where the JAX package's per-layer pool clamps them (the read is then
    masked by position)."""
    K = table.shape[0]
    base = ((torch.arange(K, device=table.device, dtype=torch.int32)
             * count + c) * n_pages)[:, None, None]
    ok = table < n_pages
    write = torch.where(ok, table + base, K * count * n_pages).int()
    read = torch.where(ok, table + base, base + n_pages - 1).int()
    return write, read


def _layer_cache(lc: dict, c: int, count: int,
                 table: Optional[torch.Tensor]):
    """One layer's cache views (+ its global (write, read) page tables
    when paged)."""
    if "k_pages" in lc:
        n_pages = lc["k_pages"].shape[2]
        fold = {k: v.view(-1, *v.shape[3:]) for k, v in lc.items()}
        return fold, global_table(table, c, count, n_pages)
    return {k: v[:, c] for k, v in lc.items()}, None


# ---------------------------------------------------------------------------
# per-slot decode and prefill (contiguous or paged)
# ---------------------------------------------------------------------------

def _ffn_step(p, spec: LayerSpec, cfg: ModelConfig, lc: dict,
              h_f: torch.Tensor, n_tok: Optional[torch.Tensor],
              moe_per_row: bool = True):
    """The block's FFN over the normed input h_f (K, B, C, d).  The rwkv
    channel-mix reads the cached shift tail and advances it in place: by
    one token (decode, n_tok None) or to each row's n_tok-th chunk
    position (prefill).  A MoE routes per row or over the batch (_moe);
    its aux loss is dropped, as in the JAX package's serving steps."""
    if spec.ffn == "moe":
        return _moe(p, cfg, h_f, moe_per_row)[0]
    if spec.ffn != "rwkv_cmix":
        return mlp_apply(p["mlp"], h_f, cfg.ffn.mlp_type)
    tail = lc["cmix_shift"].to(h_f.dtype)
    if n_tok is None:
        h = ssm.cmix_apply(p["cmix"], h_f, tail)
        lc["cmix_shift"].copy_(h_f)
        return h
    ctx = torch.cat([tail, h_f], 2)
    h = ssm.cmix_apply(p["cmix"], h_f, ctx[:, :, :h_f.shape[2]])
    lc["cmix_shift"].copy_(ssm.tail_at(ctx, n_tok, 1))
    return h


def _decode(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor):
    pos = cache["idx"][0]
    table = cache.get("page_table")
    x = embed_lookup(params, tokens, cfg)              # (K, B, 1, d)
    for seg, seg_cache, (count, specs) in zip(
            params["segments"], cache["segments"], cfg.segments()):
        for c in range(count):
            for i, spec in enumerate(specs):
                p = _layer(seg[f"slot_{i}"], c)
                lc, tbl = _layer_cache(seg_cache[f"slot_{i}"], c, count,
                                       table)
                window, theta = _mixer_window(cfg, spec)
                h_in = rmsnorm(p["norm_mix"], x, cfg.norm_eps)
                if spec.mixer == "rwkv":
                    h = ssm.rwkv_decode(p["rwkv"], h_in, lc, cfg)
                elif spec.mixer == "mamba":
                    h = ssm.mamba_decode(p["mamba"], h_in, lc, cfg)
                elif tbl is not None:
                    h = attn.gqa_decode_paged(p["attn"], h_in, lc, pos,
                                              *tbl, cfg.attn, cfg, window,
                                              theta)
                else:
                    h = attn.gqa_decode(p["attn"], h_in, lc, pos, cfg.attn,
                                        cfg, window, theta)
                x = x + h
                # the JAX package's paged step routes the batch as one
                # pool, its contiguous step (a row vmap) each row alone
                x = x + _ffn_step(p, spec, cfg, lc,
                                  rmsnorm(p["norm_ffn"], x, cfg.norm_eps),
                                  None, moe_per_row=table is None)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    out = dict(cache)
    out["idx"] = cache["idx"] + 1
    return lm_logits(params, x, cfg), out


def decode_step_slots(params, cfg: ModelConfig, cache: dict,
                      tokens: torch.Tensor):
    """Per-slot decode step: every row advances at its OWN position.
    tokens (B, 1), shared by all members; cache from init_slot_cache.
    -> (logits (K, B, 1, V), cache with idx + 1)."""
    return _decode(params, cfg, cache, tokens)


def decode_step_paged(params, cfg: ModelConfig, cache: dict,
                      tokens: torch.Tensor):
    """Per-slot decode step over a paged cache (init_slot_cache with
    page_size > 0): full-attention K/V live in shared pages behind
    cache["page_table"] and are read by the paged-attention kernel, one
    launch per paged layer for all K members.  Same contract as
    decode_step_slots; the page table rides through unchanged."""
    if "page_table" not in cache:
        raise ValueError("decode_step_paged needs a paged cache "
                         "(init_slot_cache with page_size > 0)")
    return _decode(params, cfg, cache, tokens)


def _prefill(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
             n_tok: torch.Tensor):
    idx = cache["idx"][0]
    table = cache.get("page_table")
    x = embed_lookup(params, tokens, cfg)              # (K, B, C, d)
    for seg, seg_cache, (count, specs) in zip(
            params["segments"], cache["segments"], cfg.segments()):
        for c in range(count):
            for i, spec in enumerate(specs):
                p = _layer(seg[f"slot_{i}"], c)
                lc, tbl = _layer_cache(seg_cache[f"slot_{i}"], c, count,
                                       table)
                window, theta = _mixer_window(cfg, spec)
                h_in = rmsnorm(p["norm_mix"], x, cfg.norm_eps)
                if spec.mixer == "rwkv":
                    h = ssm.rwkv_prefill(p["rwkv"], h_in, lc, n_tok, cfg)
                elif spec.mixer == "mamba":
                    h = ssm.mamba_prefill(p["mamba"], h_in, lc, n_tok, cfg)
                elif tbl is not None:
                    h = attn.gqa_prefill_paged(p["attn"], h_in, lc, idx,
                                               n_tok, *tbl, cfg.attn, cfg,
                                               window, theta)
                else:
                    h = attn.gqa_prefill(p["attn"], h_in, lc, idx, n_tok,
                                         cfg.attn, cfg, window, theta)
                x = x + h
                x = x + _ffn_step(p, spec, cfg, lc,
                                  rmsnorm(p["norm_ffn"], x, cfg.norm_eps),
                                  n_tok)
    B = tokens.shape[0]
    last = (n_tok.long() - 1).clamp_min(0)             # last valid position
    xl = x[:, torch.arange(B, device=x.device), last][:, :, None]
    xl = rmsnorm(params["final_norm"], xl, cfg.norm_eps)
    out = dict(cache)
    out["idx"] = cache["idx"] + n_tok.to(cache["idx"].dtype)
    return lm_logits(params, xl, cfg)[:, :, 0], out


def prefill_slots(params, cfg: ModelConfig, cache: dict,
                  tokens: torch.Tensor, n_tok: torch.Tensor):
    """Per-slot chunk prefill: row b consumes its OWN n_tok[b] prompt
    tokens starting at its OWN position.  tokens (B, C); n_tok (B,);
    rows with n_tok == 0 leave every plane untouched.
    -> (last-token logits (K, B, V), cache with idx + n_tok)."""
    return _prefill(params, cfg, cache, tokens, n_tok)


def prefill_step_paged(params, cfg: ModelConfig, cache: dict,
                       tokens: torch.Tensor, n_tok: torch.Tensor):
    """Consume prompt chunks over a paged cache: the slot row(s) from
    serving/kv_cache.slot_row (paged planes whole, the slot's page-table
    row along).  The chunk writes only positions [idx, idx + n_tok);
    pages below idx are read-only here.  Same contract as
    prefill_slots."""
    if "page_table" not in cache:
        raise ValueError("prefill_step_paged needs a paged cache")
    return _prefill(params, cfg, cache, tokens, n_tok)
