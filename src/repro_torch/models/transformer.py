"""Transformer LM assembly for serving and training: pattern-driven blocks
over the member-stacked params.  A block is a pre-norm mixer, attention
(GQA, ring or paged, M-RoPE for qwen2-vl; or deepseek-v2's MLA,
contiguous or paged), Mamba or rwkv6's time-mix (models/ssm.py), then,
in an encoder-decoder (whisper), a pre-norm cross-attention over the
encoder's frames, then a pre-norm FFN: a dense MLP, a MoE
(models/moe.py) or rwkv6's channel-mix.

Params keep the JAX package's tree: {"embed", ["head"], "final_norm",
"segments": [per-segment dict of "slot_<i>" blocks], and for an
encoder-decoder "enc_segments" and "enc_norm"}, every leaf with a
leading member axis K and segment leaves with the segment's `count`
axis next, (K, count, ...).  The JAX package scans each segment over
`count`; here it is a Python loop over the count axis, and the K members
run batched inside every op.

Entry points
  init(cfg, seed, device, members)          -> stacked params
  apply(params, cfg, tokens, remat,         -> (logits (K,B,T,V), aux (K,))
        embeds=, enc_embeds=)
  encode(params, cfg, enc_embeds)           -> encoder frames (K,B,S,d)
  init_slot_cache(cfg, batch, max_seq, ...) -> slot-addressable cache
  prefill(params, cfg, tokens, embeds=,     -> (last logits (K,B,V),
          enc_embeds=)                          argmax (K,B))
  decode_step_slots / decode_step_paged     -> (logits (K,B,1,V), cache)
  prefill_slots / prefill_step_paged        -> (last logits (K,B,V), cache)
  verify_slots / verify_step_paged          -> (logits (K,B,C,V), cache)

`embeds` (B, T, d) or (K, B, T, d) replaces the token embedding (the
stub frontends' input, qwen2-vl's patches); `enc_embeds` (B, S, d) or
(K, B, S, d) are whisper's frame embeddings, which `encode` turns into
the frames every decoder block cross-attends (the slot cache carries
them as "enc", (K, B, S, d)).

Caches are updated in place (see models/attention.py and
models/ssm.py); the returned cache dict shares every plane with the one
passed in and carries the advanced `idx`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.common.sharding import (REP, constrain, is_dtensor,
                                         layout_flag)
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (embed_init, embed_lookup, head_init,
                                       init_generator, lm_logits, mlp_apply,
                                       mlp_init, one_sharded_middle,
                                       rmsnorm, shift_seq,
                                       sinusoidal_positions, unfold)


# (mixer, ffn) pairs of the ported layers
_PORTED = {("attn", "dense"), ("attn_local", "dense"), ("rwkv", "rwkv_cmix"),
           ("mamba", "dense"), ("mamba", "moe"), ("attn", "moe")}


# the encoder's one block, repeated n_enc_layers times
_ENC_SPEC = LayerSpec("attn", "dense")


def _check_supported(cfg: ModelConfig) -> None:
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


def _block_init(gen, lead, cfg: ModelConfig, spec: LayerSpec, dtype, dev,
                cross: bool = False) -> dict:
    p = {"norm_mix": _rmsnorm_init(lead, cfg.d_model, dev)}
    if spec.mixer == "rwkv":
        p["rwkv"] = ssm.rwkv_init(gen, lead, cfg, dtype)
    elif spec.mixer == "mamba":
        p["mamba"] = ssm.mamba_init(gen, lead, cfg, dtype)
    else:
        p["attn"] = attn.attn_init(gen, lead, cfg, cfg.attn, dtype)
    if cross:
        p["norm_cross"] = _rmsnorm_init(lead, cfg.d_model, dev)
        p["cross"] = attn.cross_attn_init(gen, lead, cfg, cfg.attn, dtype)
    p["norm_ffn"] = _rmsnorm_init(lead, cfg.d_model, dev)
    if spec.ffn == "rwkv_cmix":
        p["cmix"] = ssm.cmix_init(gen, lead, cfg, cfg.ffn.d_ff, dtype)
    elif spec.ffn == "moe":
        p["moe"] = moe.moe_init(gen, lead, cfg.d_model, cfg.ffn, dtype)
    else:
        p["mlp"] = mlp_init(gen, lead, cfg.d_model, cfg.ffn.d_ff,
                            cfg.ffn.mlp_type, dtype)
    return p


def init(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
         members: int = 1) -> dict:
    """Member-stacked params, torch-seeded: the names, shapes and init
    scales of the JAX package's transformer.init, stacked over `members`
    (the numbers differ: torch's generator is not jax.random).  An
    encoder-decoder's decoder blocks carry "norm_cross" and "cross"; its
    encoder is one segment of n_enc_layers plain attention blocks.
    device="meta" gives every leaf's shape and dtype and draws nothing
    (the JAX package's jax.eval_shape of init)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = init_generator(seed, dev)
    dtype = torch_dtype(cfg.dtype)
    K = (members,)
    params: Dict[str, Any] = {}
    params.update(embed_init(gen, K, cfg.vocab_size, cfg.d_model, dtype))
    if not cfg.tie_embeddings:
        params.update(head_init(gen, K, cfg.vocab_size, cfg.d_model, dtype))
    params["final_norm"] = _rmsnorm_init(K, cfg.d_model, dev)
    params["segments"] = [
        {f"slot_{i}": _block_init(gen, (members, count), cfg, spec, dtype,
                                  dev, cross=cfg.enc_dec)
         for i, spec in enumerate(specs)}
        for count, specs in cfg.segments()]
    if cfg.enc_dec:
        params["enc_segments"] = [{"slot_0": _block_init(
            gen, (members, cfg.n_enc_layers), cfg, _ENC_SPEC, dtype, dev)}]
        params["enc_norm"] = _rmsnorm_init(K, cfg.d_model, dev)
    return params


def _layer(tree, c: int):
    """Slice layer c out of a (K, count, ...) segment subtree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, c) for k, v in tree.items()}
    return tree[:, c]


def _is_mla(cfg: ModelConfig, spec: LayerSpec) -> bool:
    return spec.mixer == "attn" and cfg.attn.kind == "mla"


def _mixer_window(cfg: ModelConfig, spec: LayerSpec) -> Tuple[int, float]:
    if spec.mixer == "attn":
        return cfg.attn.window, cfg.attn.rope_theta
    return cfg.local_window, cfg.local_rope_theta


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _moe(p, cfg: ModelConfig, h: torch.Tensor, pool_rows: Optional[int],
         carry: Optional[dict] = None, key=None):
    """The MoE FFN over h (K, B, S, d), every member routing its own
    tokens with one capacity per pool of pool_rows rows: each row's S
    tokens (1, as the JAX package's row-vmapped prefill and contiguous
    decode see them), each batch's where a call holds several (a
    relabel's), or all B*S tokens of the call (None: apply, paged
    decode).  With a carry the call's B rows are a piece of one pool of
    pool_rows rows: carry[key] holds this layer's per-expert arrivals of
    the pool's earlier pieces (moe.moe_apply).  -> (out (K, B, S, d),
    aux (K,) summed over the pools)."""
    K, B, S, d = h.shape
    if carry is not None:
        arrived = carry.get(key)
        if arrived is None:
            arrived = carry[key] = torch.zeros(
                K, 1, cfg.ffn.n_experts, dtype=torch.long, device=h.device)
        y, aux = moe.moe_apply(p["moe"], h.reshape(K, 1, B * S, d), cfg.ffn,
                               arrived, pool_rows * S)
        return y.reshape(K, B, S, d), aux.sum(1)
    G = B // (pool_rows or B)
    if is_dtensor(h):   # a fold of at most one sharded dim (layers.mm)
        h = one_sharded_middle(h)
        y, aux = moe.moe_apply(p["moe"], h.reshape(K, G, B // G * S, d),
                               cfg.ffn)
        return unfold(y, (K, B, S, d)), aux.sum(1)
    y, aux = moe.moe_apply(p["moe"], h.reshape(K, G, B // G * S, d),
                           cfg.ffn)
    return y.reshape(K, B, S, d), aux.sum(1)


def _block(p, spec: LayerSpec, cfg: ModelConfig, x: torch.Tensor,
           pos: torch.Tensor, train: bool, pool_rows: Optional[int],
           carry: Optional[dict] = None, key=None,
           enc: Optional[torch.Tensor] = None, causal: bool = True):
    """One block of the full-sequence forward -> (x, aux of its MoE, or
    0.0).  causal=False is the encoder's full attention; enc (K, B, S,
    d) the frames a decoder block with "cross" attends."""
    h_in = rmsnorm(p["norm_mix"], x, cfg.norm_eps)
    if spec.mixer == "rwkv":
        x = x + ssm.rwkv_apply(p["rwkv"], h_in, cfg, train=train)
    elif spec.mixer == "mamba":
        x = x + ssm.mamba_apply(p["mamba"], h_in, cfg, train=train)
    elif _is_mla(cfg, spec):
        x = x + attn.mla_apply(p["attn"], h_in, cfg.attn, cfg, pos,
                               cfg.attn.rope_theta)
    else:
        window, theta = _mixer_window(cfg, spec)
        x = x + attn.gqa_apply(p["attn"], h_in, cfg.attn, cfg, pos, window,
                               theta, causal=causal, train=train)
    x = _residual(x)
    if "cross" in p:
        x = _residual(x + attn.cross_attn_apply(
            p["cross"], rmsnorm(p["norm_cross"], x, cfg.norm_eps), enc,
            cfg.attn, flash=not train))
    h_f = rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
    aux = 0.0
    if spec.ffn == "rwkv_cmix":
        x_prev = shift_seq(h_f, 1)
        x = x + ssm.cmix_apply(p["cmix"], h_f, x_prev)
    elif spec.ffn == "moe":
        h, aux = _moe(p, cfg, h_f, pool_rows, carry, key)
        x = x + h
    else:
        x = x + mlp_apply(p["mlp"], h_f, cfg.ffn.mlp_type)
    return _residual(x), aux


def _residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's layout after a sublayer adds into it: batch
    over the batch role, the sequence over the "seq" role (sequence
    parallelism where a policy names it) or whole, the hidden dim whole:
    GSPMD's tensor-parallel residual, which the JAX package's programs
    take.  Left free, DTensor would settle each partial sum onto
    whichever dim its cost model picks (a sequence shard) and gather it
    back before every projection.  A plain tensor passes."""
    if not is_dtensor(x):
        return x
    return constrain(x, None, "batch", "seq" if layout_flag("seq") else REP,
                     REP)


def _member_input(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, T, d) shared by all members, or (K, B, T, d) -> (K, B, T, d)."""
    return x if x.dim() == 4 else x.unsqueeze(0).expand(K, *x.shape)


def _run_block(p, spec, cfg, x, pos, remat: bool, pool_rows, carry, key,
               enc=None, causal: bool = True):
    if remat:
        return checkpoint(_block, p, spec, cfg, x, pos, True, pool_rows,
                          enc=enc, causal=causal, use_reentrant=False,
                          preserve_rng_state=False)
    return _block(p, spec, cfg, x, pos, False, pool_rows, carry, key,
                  enc=enc, causal=causal)


def encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """Whisper's encoder over frame embeddings (B, S, d) shared by all
    members or (K, B, S, d) (the stub of the mel + conv frontend) ->
    frames (K, B, S, d): the sinusoid added, n_enc_layers blocks of full
    (non-causal) attention, the final norm.  remat=False runs attention
    through the flash kernel (non-causal, T = S), remat=True takes the
    training route, as apply does."""
    x = _member_input(enc_embeds, params["embed"].shape[0])
    B, S = x.shape[1:3]
    x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)
    pos = torch.arange(S, device=x.device).expand(B, S)
    seg = params["enc_segments"][0]["slot_0"]
    for c in range(cfg.n_enc_layers):
        x, _ = _run_block(_layer(seg, c), _ENC_SPEC, cfg, x, pos, remat,
                          None, None, None, causal=False)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def apply(params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
          remat: bool = False, pool_rows: Optional[int] = None,
          carry: Optional[dict] = None,
          embeds: Optional[torch.Tensor] = None,
          enc_embeds: Optional[torch.Tensor] = None):
    """tokens (B, T) shared by all members, or (K, B, T) with one batch
    per member, or embeds (B, T, d) / (K, B, T, d) in their place ->
    (logits (K, B, T, V), aux): aux is the MoE layers'
    summed load-balance loss per member, (K,), or 0.0 for a model
    without MoE, as the JAX package's apply returns it.  An
    encoder-decoder adds the sinusoid to its input (no RoPE) and
    cross-attends encode(enc_embeds) in every block.  A MoE layer
    routes each run of pool_rows rows as one token pool, with one
    capacity (None: all B rows, as one call of the JAX package's apply
    sees them), so that a call over several batches routes each as the
    JAX package does.  carry (a dict, empty for a pool's first piece):
    the B rows are a piece of one pool of pool_rows rows, scored in
    several calls; the MoE layers keep their arrival counts in it from
    one piece to the next (_moe).

    remat=False is the forward-only route (relabel, eval, serving):
    attention and the recurrences go through ops.flash_attention,
    ops.wkv6 and ops.ssm_scan, which on the card are the hand-written
    kernels and have no backward.  remat=True is the training route, the
    counterpart of the JAX package's remat=True: each block runs under
    torch.utils.checkpoint (its activations recomputed in the backward),
    attention through attention.attend and the recurrences through their
    chunked plain forms (models/ssm.py)."""
    x, aux = _forward(params, cfg, tokens, remat, pool_rows, carry, embeds,
                      enc_embeds)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, x, cfg), aux


def _embed_in(params, cfg: ModelConfig, tokens, embeds) -> torch.Tensor:
    if embeds is not None:
        return _member_input(embeds, params["embed"].shape[0])
    return constrain(embed_lookup(params, tokens, cfg),
                     None, "batch", None, None)


def _forward(params, cfg: ModelConfig, tokens, remat: bool, pool_rows,
             carry, embeds, enc_embeds):
    """apply's blocks -> (the last block's output (K, B, T, d), aux)."""
    _check_supported(cfg)
    x = _embed_in(params, cfg, tokens, embeds)
    B, T = x.shape[1:3]
    if cfg.enc_dec and not cfg.attn.use_rope:
        x = x + sinusoidal_positions(T, cfg.d_model, x.device).to(x.dtype)
    enc = encode(params, cfg, enc_embeds, remat) if cfg.enc_dec else None
    pos = torch.arange(T, device=x.device).expand(B, T)
    aux = 0.0
    for si, (seg, (count, specs)) in enumerate(zip(params["segments"],
                                                   cfg.segments())):
        for c in range(count):
            for i, spec in enumerate(specs):
                x, a = _run_block(_layer(seg[f"slot_{i}"], c), spec, cfg, x,
                                  pos, remat, pool_rows, carry, (si, c, i),
                                  enc=enc)
                aux = aux + a
    return x, aux


def prefill(params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None):
    """The forward scoring pass of the dry-run's prefill cell (the JAX
    package's transformer.prefill): apply's forward-only route (the flash
    kernel) without holding logits for every position -> (last-token
    logits (K, B, V), their argmax (K, B)).  The serving engine fills its
    cache with prefill_slots / prefill_step_paged instead."""
    x, _ = _forward(params, cfg, tokens, False, None, None, embeds,
                    enc_embeds)
    x = rmsnorm(params["final_norm"], x[:, :, -1:], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)[:, :, 0]
    # the argmax over a vocab-sharded DTensor reads it whole
    return logits, constrain(logits, None, None, REP).argmax(-1)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def layer_pages(cfg: ModelConfig, spec: LayerSpec, max_seq: int) -> bool:
    """Does this layer page its positional cache under paged serving?
    Full-attention layers (window 0 or >= max_seq) hold O(max_seq) per
    slot, which is what paging fixes; ring-bounded sliding-window layers
    keep their per-slot rings.  MLA layers always attend over the whole
    sequence, so they always page."""
    if spec.mixer == "attn":
        return (cfg.attn.kind == "mla" or cfg.attn.window <= 0
                or cfg.attn.window >= max_seq)
    if spec.mixer == "attn_local":
        return cfg.local_window <= 0 or cfg.local_window >= max_seq
    return False


def init_slot_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    page_size: int = 0, n_pages: int = 0, members: int = 1,
                    device: DeviceLike = None,
                    kv_dtype: str = "f32") -> dict:
    """Slot-addressable decode cache for `members` stacked members.

      idx            (K, B) int32           per-slot position
      ring planes    (K, count, B, S, Hkv, dh); MLA "c_kv" (K, count, B,
                     S, r), "k_r" (K, count, B, S, rope)
      paged planes   (K, count, n_pages, page_size, Hkv, dh); MLA
                     "c_kv_pages" (K, count, n_pages, page_size, r),
                     "k_r_pages" (..., rope)
      page_table     (K, B, ceil(max_seq / page_size)) int32, all
                     sentinel (n_pages = unallocated)
      recurrent      mamba "conv" (K, count, B, conv_w-1, d_inner), "ssm"
      planes         (K, count, B, d_inner, d_state) f32; rwkv "shift"
                     (K, count, B, 1, d), "wkv" (K, count, B, H, dh, dh)
                     f32; channel-mix "cmix_shift" (K, count, B, 1, d)
      enc            (K, B, enc_max_frames, d) zeros: an encoder-
                     decoder's frames, which the caller fills (the
                     engine with its encoder stub)

    With page_size > 0 the full-attention layers (layer_pages) get the
    shared paged pool; the other layers keep per-slot planes (a model
    with no full-attention layer, rwkv6, pages nothing and keeps only
    the page table).  kv_dtype sets the paged planes' storage
    (attention.kv_storage_dtype); "int8" / "fp8" add the f32
    "*_scale_pages" sidecars, (K, count, n_pages, page_size, Hkv) for
    GQA, "c_kv_scale_pages" (K, count, n_pages, page_size) for MLA.
    Rings and recurrent state keep the model's dtype."""
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
                init_pages = (attn.mla_paged_cache_init if _is_mla(cfg, spec)
                              else attn.gqa_paged_cache_init)
                c = init_pages(cfg.attn, lead, n_pages, page_size, dtype,
                               dev, kv_dtype)
            elif _is_mla(cfg, spec):
                c = attn.mla_cache_init(cfg.attn, lead, batch, max_seq,
                                        dtype, dev)
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
    if cfg.enc_dec:
        cache["enc"] = torch.zeros(members, batch, cfg.enc_max_frames,
                                   cfg.d_model, dtype=dtype, device=dev)
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
    when paged: any "*_pages" plane, GQA's or MLA's)."""
    pages = [v for k, v in lc.items() if k.endswith("_pages")]
    if pages:
        n_pages = pages[0].shape[2]
        fold = {k: v.view(-1, *v.shape[3:]) for k, v in lc.items()}
        return fold, global_table(table, c, count, n_pages)
    return {k: v[:, c] for k, v in lc.items()}, None


def absorb_mla_params(cfg: ModelConfig, params: dict) -> dict:
    """A tree with the absorbed-MLA projections beside every MLA layer's
    kv_up: kv_uk (..., r, H, nope) and kv_uv (..., r, H, v), the JAX
    package's absorb_mla_params.  Here they are views of kv_up
    (attention.mla_absorbed), which the paged decode takes from kv_up
    itself, so the engine installs no extra leaves.  Non-MLA configs
    pass through."""
    a = cfg.attn
    if a.kind != "mla":
        return params
    out = dict(params)
    out["segments"] = []
    for seg, (_, specs) in zip(params["segments"], cfg.segments()):
        seg = dict(seg)
        for i, spec in enumerate(specs):
            slot = seg[f"slot_{i}"]
            if _is_mla(cfg, spec) and "kv_up" in slot.get("attn", {}):
                p = dict(slot["attn"])
                p["kv_uk"], p["kv_uv"] = attn.mla_absorbed(p, a)
                seg[f"slot_{i}"] = {**slot, "attn": p}
        out["segments"].append(seg)
    return out


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
        return _moe(p, cfg, h_f, 1 if moe_per_row else None)[0]
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


def _sinusoid_at(cfg: ModelConfig, x: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """x (K, B, C, d) at positions idx[b]..idx[b]+C-1 plus the sinusoid,
    for an encoder-decoder without RoPE (else x as is).  Each row's
    start clamps to [0, max_seq - C], where the JAX package's
    dynamic_slice of its (max_seq, d) table puts it."""
    if not cfg.enc_dec or cfg.attn.use_rope:
        return x
    C = x.shape[2]
    start = idx.long().clamp(0, max(cfg.max_seq - C, 0))
    return x + sinusoidal_positions(C, cfg.d_model, x.device,
                                    start).to(x.dtype)


def _cross(p, cfg: ModelConfig, cache: dict, x: torch.Tensor,
           flash: bool) -> torch.Tensor:
    """x plus the block's cross-attention over cache["enc"] (none
    without "cross")."""
    x = _residual(x)
    if "cross" not in p:
        return x
    return _residual(x + attn.cross_attn_apply(
        p["cross"], rmsnorm(p["norm_cross"], x, cfg.norm_eps), cache["enc"],
        cfg.attn, flash))


def _decode(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor):
    pos = cache["idx"][0]
    table = cache.get("page_table")
    x = _sinusoid_at(cfg, _embed_in(params, cfg, tokens, None), pos)
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
                elif tbl is not None and "c_kv_pages" in lc:
                    h = attn.mla_decode_paged(p["attn"], h_in, lc, pos,
                                              *tbl, cfg.attn, cfg, theta)
                elif tbl is not None:
                    h = attn.gqa_decode_paged(p["attn"], h_in, lc, pos,
                                              *tbl, cfg.attn, cfg, window,
                                              theta)
                elif _is_mla(cfg, spec):
                    h = attn.mla_decode(p["attn"], h_in, lc, pos, cfg.attn,
                                        cfg, theta)
                else:
                    h = attn.gqa_decode(p["attn"], h_in, lc, pos, cfg.attn,
                                        cfg, window, theta)
                x = _cross(p, cfg, cache, x + h, flash=False)
                # the JAX package's paged step routes the batch as one
                # pool, its contiguous step (a row vmap) each row alone
                x = _residual(x + _ffn_step(
                    p, spec, cfg, lc, rmsnorm(p["norm_ffn"], x, cfg.norm_eps),
                    None, moe_per_row=table is None))
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
             n_tok: torch.Tensor, verify: bool = False):
    """The chunk step of prefill and of speculative verify.  verify=True
    keeps the logits of every chunk position and, over the paged pool,
    scores the chunk through the verify attention (scatter, then gather)
    with the MoE routing the whole batch as one pool, as the JAX
    package's paged verify does; there only attention mixers may run."""
    idx = cache["idx"][0]
    table = cache.get("page_table")
    per_row = not (verify and table is not None)
    x = _sinusoid_at(cfg, embed_lookup(params, tokens, cfg), idx)
    for seg, seg_cache, (count, specs) in zip(
            params["segments"], cache["segments"], cfg.segments()):
        for c in range(count):
            for i, spec in enumerate(specs):
                p = _layer(seg[f"slot_{i}"], c)
                lc, tbl = _layer_cache(seg_cache[f"slot_{i}"], c, count,
                                       table)
                window, theta = _mixer_window(cfg, spec)
                h_in = rmsnorm(p["norm_mix"], x, cfg.norm_eps)
                if verify and table is not None and spec.mixer not in (
                        "attn", "attn_local"):
                    raise ValueError(
                        f"speculative verify needs attention-only layers, "
                        f"got mixer {spec.mixer!r}")
                if spec.mixer == "rwkv":
                    h = ssm.rwkv_prefill(p["rwkv"], h_in, lc, n_tok, cfg)
                elif spec.mixer == "mamba":
                    h = ssm.mamba_prefill(p["mamba"], h_in, lc, n_tok, cfg)
                elif tbl is not None and "c_kv_pages" in lc:
                    h = attn.mla_prefill_paged(p["attn"], h_in, lc, idx,
                                               n_tok, *tbl, cfg.attn, cfg,
                                               theta)
                elif tbl is not None:
                    gqa = (attn.gqa_verify_paged if verify
                           else attn.gqa_prefill_paged)
                    h = gqa(p["attn"], h_in, lc, idx, n_tok, *tbl, cfg.attn,
                            cfg, window, theta)
                elif _is_mla(cfg, spec):
                    h = attn.mla_prefill(p["attn"], h_in, lc, idx, n_tok,
                                         cfg.attn, cfg, theta)
                else:
                    h = attn.gqa_prefill(p["attn"], h_in, lc, idx, n_tok,
                                         cfg.attn, cfg, window, theta)
                x = _cross(p, cfg, cache, x + h, flash=True)
                x = x + _ffn_step(p, spec, cfg, lc,
                                  rmsnorm(p["norm_ffn"], x, cfg.norm_eps),
                                  n_tok, moe_per_row=per_row)
    out = dict(cache)
    out["idx"] = cache["idx"] + n_tok.to(cache["idx"].dtype)
    if verify:
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return lm_logits(params, x, cfg), out
    B = tokens.shape[0]
    last = (n_tok.long() - 1).clamp_min(0)             # last valid position
    xl = x[:, torch.arange(B, device=x.device), last][:, :, None]
    xl = rmsnorm(params["final_norm"], xl, cfg.norm_eps)
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


def verify_slots(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                 n_tok: torch.Tensor):
    """Per-slot chunk verify over the contiguous pool: prefill_slots that
    keeps the logits of ALL C positions.  tokens (B, C) at each row's
    own position; n_tok (B,) valid tokens (0: the row is left
    untouched).  -> (logits (K, B, C, V), cache with idx + n_tok):
    logits[:, :, j] is the next-token distribution after chunk entry j,
    what speculative verify checks every drafted position against.  The
    chunk's K/V stay in the cache; the caller rolls back what it rejects
    (kv_cache.restore_positions)."""
    return _prefill(params, cfg, cache, tokens, n_tok, verify=True)


def verify_step_paged(params, cfg: ModelConfig, cache: dict,
                      tokens: torch.Tensor, n_tok: torch.Tensor):
    """Score a C-token chunk for EVERY slot over the paged pool, each at
    its own position: paged layers scatter the chunk, then attend over
    the gathered pages (attention.gqa_verify_paged, the flash kernel on
    the card; MLA's mla_prefill_paged), ring layers take their chunk
    prefill (the flash kernel over the ring plus the chunk).  Same
    contract as verify_slots; a model with a recurrent mixer raises (its
    state has no position axis to roll back)."""
    if "page_table" not in cache:
        raise ValueError("verify_step_paged needs a paged cache")
    return _prefill(params, cfg, cache, tokens, n_tok, verify=True)
