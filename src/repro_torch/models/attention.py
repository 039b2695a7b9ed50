"""GQA and MLA attention: full-sequence apply, ring or contiguous cache
decode and prefill, and the paged-pool decode and prefill of the serving
engine.

Shapes carry the member axis K first: x is (K, B, T, d).  The core math
(`attend`) folds members into the batch, (K*B, T, H, dh).  Positions are
per row, (B,) or (B, T), shared by all members.

Cache planes are updated IN PLACE: the JAX package returns new planes and
relies on buffer donation; here the functions write through the views
they are given (so a slot row taken with kv_cache.slot_row writes into
the pool) and return only the attention output.

Kernels: the full-sequence forward (`gqa_apply`, but for its training
route, which takes `attend`) and both chunked
prefills (`gqa_prefill` over a ring, `gqa_prefill_paged` over gathered
pages, each plus the chunk) go through kernels/ops.flash_attention, one
call per layer with the K members folded into its rows; paged decode
reads go through kernels/ops.paged_attention.  On the card both are
hand-written CUDA kernels.  Ring-layer decode (`gqa_decode`) stays on
`attend`, whose two paths are numerically identical: `_attend_dense`
materializes the score matrix, `_attend_chunked` loops over KV chunks
with an online-softmax accumulator.

M-RoPE (qwen2-vl) rotates by three position streams that coincide for
text, wherever RoPE rotates (`_qkv`).  Cross-attention
(whisper's decoder) attends over the encoder's frames unmasked: through
the flash kernel, non-causal, where the forward-only routes run it, and
through `attend` in training and the one-token decode.

Quantized pages: under kv_dtype "int8" / "fp8" a paged plane is stored
in one byte an entry with a per-token (per kv head) f32 absmax scale in
a sidecar `<plane>_scale_pages`; writes quantize (kv_quantize, bit for
bit the JAX package's), decode hands the scales to the paged kernel,
and the prefill / verify reads dequantize the gathered pages.  Rings and
recurrent state are never quantized.

Speculative verify (`gqa_verify_paged`; MLA's is `mla_prefill_paged`)
scores a chunk of C draft tokens for every slot at its own position:
the chunk's K/V land in the pages first, then every query attends over
the gathered (dequantized) view, through the flash kernel at per-row
positions for GQA.

MLA (deepseek-v2's multi-head latent attention) caches a per-token
latent and one shared rope key.  Its paged decode runs in the absorbed
form through kernels/ops.paged_attention (one launch per layer for all
K members, the latent pages as keys and values, the rope keys as
`k_extra`); its apply and prefills expand the latent and take `attend`,
as the JAX package does (the flash kernel takes only dk = dv).  The
JAX package's MLA has no norm on the latents, so neither has this.

Layouts: under the dry-run (launch/specs.py) the tensors are DTensors and
the `constrain` calls below are the JAX package's with_sharding_constraint
sites, each with a leading None for the member dim: heads over "model"
where the head count divides it, else the flat projections replicated
before the head reshape (`_head_spec`).  On a plain tensor they do nothing.

Numerics: `attend` rounds the probabilities to the input dtype before
the value product, as the JAX package's `attend` does; the flash path
keeps them in f32, as the TPU flash kernel does.  At f32 the two agree
to rounding (the port's prefill matches the JAX prefill within 2e-5);
at bf16 they differ by one bf16 rounding of p.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.common.sharding import (REP, constrain, is_dtensor,
                                         mesh_axis_size)
from repro_torch.common.types import AttnConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, member_view, mm

NEG_INF = -2.0 ** 30  # large-negative that survives bf16 round-trips
FAR = -(10 ** 9)      # position sentinel of an empty / padded cache entry

# chunk size for the online-softmax path; seqs <= this use the dense path
ATTN_CHUNK = 1024


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def attn_init(gen, lead, cfg: ModelConfig, a: AttnConfig, dtype) -> dict:
    d = cfg.d_model
    if a.kind == "mla":
        p = {
            "kv_down": dense_init(gen, lead, (d, a.kv_lora_rank), dtype),
            "k_rope": dense_init(gen, lead, (d, a.qk_rope_dim), dtype),
            # per-head up-projections from the shared latent
            "kv_up": dense_init(
                gen, lead, (a.kv_lora_rank,
                            a.n_heads * (a.qk_nope_dim + a.v_head_dim)),
                dtype),
            "w_o": dense_init(gen, lead, (a.n_heads * a.v_head_dim, d),
                              dtype),
        }
        if a.q_lora_rank:
            p["q_down"] = dense_init(gen, lead, (d, a.q_lora_rank), dtype)
            p["q_up"] = dense_init(gen, lead, (a.q_lora_rank, a.q_dim),
                                   dtype)
        else:
            p["w_q"] = dense_init(gen, lead, (d, a.q_dim), dtype)
        return p
    if a.kind != "gqa":
        raise NotImplementedError(f"attention kind {a.kind!r} is not ported")
    p = {
        "w_q": dense_init(gen, lead, (d, a.n_heads * a.head_dim), dtype),
        "w_k": dense_init(gen, lead, (d, a.n_kv_heads * a.head_dim), dtype),
        "w_v": dense_init(gen, lead, (d, a.n_kv_heads * a.head_dim), dtype),
        "w_o": dense_init(gen, lead, (a.n_heads * a.head_dim, d), dtype),
    }
    if a.qk_norm:
        ones = torch.ones(*lead, a.head_dim, dtype=torch.float32,
                          device=gen.device)
        p["norm_q"] = ones
        p["norm_k"] = ones.clone()
    return p


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, ...) per-row tensor -> (K*B, ...), repeated for every member."""
    return x.unsqueeze(0).expand(K, *x.shape).reshape(K * x.shape[0],
                                                      *x.shape[1:])


def _mask_bias(q_pos, k_pos, window: int, causal: bool) -> torch.Tensor:
    """(..., Tq) x (..., Tk) positions -> (..., Tq, Tk) additive mask.
    window > 0 limits lookback; negative k positions are the empty /
    padded cache-slot sentinel and are always masked out."""
    kp = k_pos[..., None, :]
    qp = q_pos[..., :, None]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _add_bias(s: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    # s (N, Hkv, g, Tq, Tk); bias (Tq, Tk) shared or (N, Tq, Tk) per row
    return s + (bias[:, None, None] if bias.dim() == 3 else bias)


def _attend_dense(q, k, v, bias, scale) -> torch.Tensor:
    """q (N, Tq, H, dh), k/v (N, Tk, Hkv, dh|dv) -> (N, Tq, H, dv).

    Operands round to q's dtype and products accumulate in f32, the
    JAX package's precision convention (preferred_element_type=f32)."""
    N, Tq, H, dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    cdt = q.dtype
    qg = q.reshape(N, Tq, Hkv, g, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(cdt).float()) * scale
    p = torch.softmax(_add_bias(s, bias), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(cdt).float(),
                     v.to(cdt).float())
    return o.reshape(N, Tq, H, v.shape[-1]).to(v.dtype)


def _attend_chunked(q, k, v, q_pos, k_pos, window, causal, scale,
                    chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """Online softmax over KV chunks; the same result as _attend_dense
    with O(Tq * chunk) live scores."""
    N, Tq, H, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    dv = v.shape[-1]
    cdt = q.dtype
    qf = q.reshape(N, Tq, Hkv, g, dh).float()
    m = torch.full((N, Hkv, g, Tq), NEG_INF, device=q.device)
    l = torch.zeros((N, Hkv, g, Tq), device=q.device)
    acc = torch.zeros((N, Hkv, g, Tq, dv), device=q.device)
    for i0 in range(0, Tk, chunk):
        kb = k[:, i0:i0 + chunk].to(cdt).float()
        vb = v[:, i0:i0 + chunk].to(cdt).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb) * scale
        s = _add_bias(s, _mask_bias(q_pos, k_pos[..., i0:i0 + chunk],
                                    window, causal))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(cdt).float(), vb)
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(N, Tq, H, dv).to(v.dtype)


def _heads_sharded_layout(q, k, v):
    """The layout DTensor q, k, v share once each takes the others'
    shards (each mesh dim shards at most rows (dim 0) or heads (dim 2),
    the same in all three, or leaves a tensor whole), when it shards the
    heads: the score einsum would fold sharded heads into one batch dim
    after the rows, which DTensor's view rule (torch 2.11) refuses.
    None otherwise (plain tensors, other layouts)."""
    if not all(is_dtensor(t) for t in (q, k, v)):
        return None
    lay = []
    for ps in zip(q.placements, k.placements, v.placements):
        if any(p.is_partial() for p in ps):
            return None
        dims = {p.dim for p in ps if p.is_shard()}
        if len(dims) > 1 or not dims <= {0, 2}:
            return None
        lay.append(next((p for p in ps if p.is_shard()), ps[0]))
    return lay if any(p.is_shard(2) for p in lay) else None


def _attend_shard_local(q, k, v, q_pos, k_pos, **kw) -> torch.Tensor:
    """attend on each rank's shard of rows and heads (every row and head
    attends alone), rebuilt as a DTensor of q's layout.  Per-row
    positions are cut to this rank's rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, lay = q.device_mesh, q.placements
    n, r0 = (x[0] for x in compute_local_shape_and_global_offset(
        q.shape, mesh, lay))
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in lay]

    def local_pos(p):
        if p is None or p.dim() == 1:
            return p.full_tensor() if is_dtensor(p) else p
        if is_dtensor(p):
            return p.redistribute(mesh, rows).to_local()
        return p[r0:r0 + n]

    o = attend(q.to_local(), k.to_local(), v.to_local(), local_pos(q_pos),
               local_pos(k_pos), **kw).contiguous()
    shape = (*q.shape[:3], v.shape[-1])
    return DTensor.from_local(o, mesh, lay, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _paired(q, k, v):
    """Folded q (N, T, H, dh), k / v (N, S, Hkv, *) for the core math.
    Over DTensors whose query heads are sharded where the kv heads are
    too few to be (the JAX package's REP kv layout), DTensor cannot split
    the sharded heads into (Hkv, g) groups: a one-query step gathers its
    query heads (a head a rank is a small read; the keys may be sharded
    over the sequence), a longer one repeats each kv head for its group,
    so that heads pair up shard by shard (a rank then holds as many kv
    rows as the reference's replicated ones).  Plain tensors pass."""
    if not is_dtensor(q) or k.shape[2] == q.shape[2] or not any(
            getattr(p, "dim", None) == 2 for p in q.placements):
        return q, k, v
    if q.shape[1] == 1:
        return constrain(q, None, None, REP, None), k, v
    g = q.shape[2] // k.shape[2]
    # in training the repeat's gradient sums over each group, which
    # DTensor cannot split out of sharded heads: the repeated heads stay
    # whole (each rank reads its queries' shard of them; the backward
    # gathers their gradient first, a cost the reference's partial sums
    # do not pay: ROADMAP, queue 3)
    lay = REP if k.requires_grad else "model"

    def heads(t):
        return constrain(t.repeat_interleave(g, dim=2), None, None, lay,
                         None)
    return q, heads(k), heads(v)


def attend(q, k, v, q_pos, k_pos, *, window: int, causal: bool,
           scale: float, force_dense: Optional[bool] = None) -> torch.Tensor:
    """Dispatch dense vs chunked on KV length.  Positions are (T,) shared
    by every row or (N, T) per row."""
    q, k, v = _paired(q, k, v)
    lay = _heads_sharded_layout(q, k, v)
    if lay is not None:
        # a tensor whole where another is sharded (the GQA repeat in
        # training, a decode step's gathered query heads) takes its
        # shard: a local slice
        q, k, v = (t.redistribute(t.device_mesh, lay) for t in (q, k, v))
        return _attend_shard_local(q, k, v, q_pos, k_pos, window=window,
                                   causal=causal, scale=scale,
                                   force_dense=force_dense)
    Tk = k.shape[1]
    dense = Tk <= ATTN_CHUNK if force_dense is None else force_dense
    if is_dtensor(k) and q.shape[1] == 1:
        # a one-query step over a DTensor cache (the dry-run's, its keys
        # possibly sharded over the sequence): the chunk loop's slices
        # would gather every shard, the dense scores are one row a head
        dense = True
    if dense:
        return _attend_dense(q, k, v, _mask_bias(q_pos, k_pos, window,
                                                 causal), scale)
    return _attend_chunked(q, k, v, q_pos, k_pos, window, causal, scale)


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _maybe_qknorm(params, q, k, eps):
    if "norm_q" in params:
        def rn(x, w):
            xf = x.float()
            var = xf.square().mean(-1, keepdim=True)
            return (xf * torch.rsqrt(var + eps) * member_view(w, xf)
                    ).to(x.dtype)
        q, k = rn(q, params["norm_q"]), rn(k, params["norm_k"])
    return q, k


def _head_spec(n: int, x):
    """Layout of n heads: over "model" when they divide it, else
    replicated (the JAX package's gqa: the KV heads of a GQA whole on
    every rank while the Q heads split; its Q heads' rule reduces to
    the same test, since they are a multiple of the KV heads)."""
    return "model" if n % mesh_axis_size("model", x) == 0 else REP


def _heads(flat: torch.Tensor, n: int, dh: int, spec) -> torch.Tensor:
    """A projection (K, B, T, n*dh) -> (K, B, T, n, dh), its heads laid
    out by `spec`.  REP replicates the FLAT projection before the head
    reshape: a column sharding that survives into the reshape lands
    inside head_dim and turns the score contraction into partial sums."""
    if spec == REP:
        flat = constrain(flat, None, None, None, REP)
    return constrain(flat.reshape(*flat.shape[:-1], n, dh),
                     None, None, None, spec, None)


def _qkv(params, x, a: AttnConfig, cfg: ModelConfig, pos, theta):
    """x (K, B, T, d), pos (B, T) -> rotated q (K,B,T,H,dh), k, v."""
    q, k, v = (_heads(mm(x, params[w]), n, a.head_dim, _head_spec(n, x))
               for w, n in (("w_q", a.n_heads), ("w_k", a.n_kv_heads),
                            ("w_v", a.n_kv_heads)))
    q, k = _maybe_qknorm(params, q, k, cfg.norm_eps)
    if a.use_rope:
        # M-RoPE's three position streams (temporal, height, width)
        # coincide for text, as in the JAX package's _positions_for
        rp = pos if a.mrope_sections is None else pos.expand(3, *pos.shape)
        q = apply_rope(q, rp, theta, a.mrope_sections)
        k = apply_rope(k, rp, theta, a.mrope_sections)
    return q, k, v


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(K, B, ...) -> (K*B, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _out(params, o: torch.Tensor, K: int, B: int) -> torch.Tensor:
    """Folded heads' output o (K*B, T, H, dv) -> (K, B, T, d) through
    w_o, the heads over "model" where they divide it."""
    hs = _head_spec(o.shape[2], o)
    o = constrain(o, None, None, hs, None)
    # the flat view too: its gradient must reach the head reshape in the
    # heads' layout, not the row-parallel w_o's (DTensor cannot split a
    # flat dim sharded 16 ways into 4 heads)
    flat = constrain(o.reshape(K, B, o.shape[1], -1), None, None, None, hs)
    return mm(flat, params["w_o"])


def gqa_apply(params: dict, x: torch.Tensor, a: AttnConfig,
              cfg: ModelConfig, positions: torch.Tensor, window: int,
              theta: float, causal: bool = True,
              train: bool = False) -> torch.Tensor:
    """x (K, B, T, d), positions (B, T) -> (K, B, T, d).  positions are
    0..T-1 in every row (transformer.apply's), so the attention mask is
    the flash kernel's top-left one.

    The flash kernel is forward-only.  train=True takes the training
    route instead: `attend`, plain PyTorch that autograd differentiates,
    as the JAX package trains through its jnp attend."""
    K, B, T, _ = x.shape
    q, k, v = _qkv(params, x, a, cfg, positions, theta)
    scale = 1.0 / math.sqrt(a.head_dim)
    if train:
        o = attend(_fold(q), _fold(k), _fold(v), positions[0],
                   positions[0], window=window, causal=causal, scale=scale)
    else:
        o = ops.flash_attention(*_paired(_fold(q), _fold(k), _fold(v)),
                                causal=causal, window=window, scale=scale)
    return _out(params, o, K, B)


# ---------------------------------------------------------------------------
# in-place masked writes (torch has no scatter "drop" mode)
# ---------------------------------------------------------------------------

def _put_rows(flat: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor,
              valid: torch.Tensor) -> None:
    """flat[:, tgt[i]] = vals[:, i] where valid[i]; other i write nothing.

    flat (L, N, F) is a view of a cache plane, tgt (M,) row ids, vals
    (L, M, F), valid (M,) bool.  Filtering the rows out with a boolean
    index would wait for the device, so instead each dropped row repeats
    the first valid row's write (same target, same value), or, when no
    row is valid, rewrites row 0 with its own content.  Duplicate indices
    then always carry equal values, so the unordered index_put_ is
    deterministic and the plane ends as if the dropped rows never wrote.
    """
    if flat.dtype == torch.float8_e4m3fn:
        return _put_rows(_raw(flat), tgt, _raw(vals.to(flat.dtype)), valid)
    tgt = torch.where(valid, tgt, 0).clamp(0, flat.shape[1] - 1)
    j = valid.int().argmax()            # first valid row (0 if none)
    t_j = tgt[j]
    fill = torch.where(valid.any(), vals[:, j].to(flat.dtype), flat[:, t_j])
    tgt = torch.where(valid, tgt, t_j)
    vals = torch.where(valid[None, :, None], vals.to(flat.dtype),
                       fill[:, None])
    flat[:, tgt] = vals


def _plane_rows(plane: torch.Tensor) -> torch.Tensor:
    """(L, R, ..., F-ish) plane view -> (L, rows, F) view (no copy; a
    plane that cannot be viewed so raises rather than copying away the
    in-place write)."""
    return plane.view(plane.shape[0], -1,
                      math.prod(plane.shape[-2:]))


# ---------------------------------------------------------------------------
# ring / contiguous per-slot cache: decode and chunk prefill
# ---------------------------------------------------------------------------

def gqa_cache_init(a: AttnConfig, lead, batch: int, max_seq: int,
                   window: int, dtype, device) -> dict:
    slots = min(window, max_seq) if window > 0 else max_seq
    shape = (*lead, batch, slots, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ring_pos(idx: torch.Tensor, slots: int, window: int) -> torch.Tensor:
    """(B,) positions -> (B, slots) absolute position held by each slot
    after the write at idx; empty / future slots get the FAR sentinel."""
    slot_ids = torch.arange(slots, device=idx.device)
    i = idx.long()[:, None]
    if window > 0:
        # slot s holds the most recent position p <= idx with p % S == s
        k_pos = i - ((i - slot_ids) % slots)
        return torch.where(k_pos > i, FAR, k_pos)
    return torch.where(slot_ids <= i, slot_ids, FAR)


def _write_token(plane: torch.Tensor, vals: torch.Tensor,
                 rows: torch.Tensor, slot: torch.Tensor) -> None:
    """plane (K, B, S, ...)[:, rows, slot] = vals (K, B, ...), in place,
    rows = arange(B).  A DTensor plane (the dry-run's sharded cache)
    writes shard by shard (_write_token_local)."""
    if is_dtensor(plane):
        _write_token_local(plane, vals, slot)
    else:
        plane[:, rows, slot] = vals


def _write_token_local(plane, vals, slot) -> None:
    """_write_token on this rank's shard of a DTensor plane: the rows it
    holds whose slot lies in its share of S, an indexed write of one
    token a row, as the reference's in-place update (an indexed write
    into the DTensor would gather its sharded dims).  A row whose slot
    lies on another shard rewrites its own entry at a clamped slot."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = plane.device_mesh
    rep = [Replicate()] * mesh.ndim
    # vals in the plane's layout (its dims past S one lower); a mesh dim
    # that splits S holds vals whole
    lay = [Shard(p.dim - (p.dim > 2)) if isinstance(p, Shard)
           and p.dim != 2 else Replicate() for p in plane.placements]
    if not is_dtensor(vals):
        vals = DTensor.from_local(vals, mesh, rep, run_check=False)
    vals = vals.redistribute(mesh, lay).to_local()
    if is_dtensor(slot):
        slot = slot.redistribute(mesh, rep).to_local()
    shape, off = compute_local_shape_and_global_offset(
        plane.shape, mesh, plane.placements)
    local = plane.to_local()
    at = slot[off[1]:off[1] + shape[1]].long() - off[2]
    inside = ((at >= 0) & (at < shape[2])).reshape(
        1, shape[1], *([1] * (vals.dim() - 2)))
    at = at.clamp(0, shape[2] - 1)
    rows = torch.arange(shape[1], device=local.device)
    local[:, rows, at] = torch.where(inside, vals.to(local.dtype),
                                     local[:, rows, at])


def gqa_decode(params: dict, x: torch.Tensor, cache: dict,
               idx: torch.Tensor, a: AttnConfig, cfg: ModelConfig,
               window: int, theta: float) -> torch.Tensor:
    """One-token decode over per-slot planes, every row at its OWN
    position (the JAX package's row vmap of gqa_decode, written out).

    x (K, B, 1, d); idx (B,); cache {"k", "v": (K, B, S, Hkv, dh)},
    written in place (window > 0: ring slot idx % S).  -> (K, B, 1, d).
    """
    K, B = x.shape[:2]
    pos = idx.long()[:, None]
    q, k, v = _qkv(params, x, a, cfg, pos, theta)
    S = cache["k"].shape[2]
    slot = pos[:, 0] % S if window > 0 else pos[:, 0]
    rows = torch.arange(B, device=x.device)
    _write_token(cache["k"], k[:, :, 0], rows, slot)
    _write_token(cache["v"], v[:, :, 0], rows, slot)
    k_pos = _ring_pos(idx, S, window)
    o = attend(_fold(q), _fold(cache["k"]), _fold(cache["v"]),
               _rows(pos, K), _rows(k_pos, K), window=window, causal=True,
               scale=1.0 / math.sqrt(a.head_dim),
               force_dense=S <= ATTN_CHUNK * 4)
    return _out(params, o, K, B)


def chunk_cache_write(plane: torch.Tensor, chunk: torch.Tensor,
                      idx: torch.Tensor, n_tok: torch.Tensor,
                      window: int) -> None:
    """Bulk-write prompt chunks into a per-slot plane, in place.

    plane (K, B, S, Hkv, dh); chunk (K, B, C, Hkv, dh) holds positions
    idx[b]..idx[b]+n_tok[b]-1 (t >= n_tok is padding, NOT written).  For
    sliding-window rings the slot of position p is p % S and a chunk
    longer than the ring keeps only its last S positions, so targets
    never collide.  n_tok == 0 writes nothing.
    """
    K, B, S = plane.shape[:3]
    C = chunk.shape[2]
    t = torch.arange(C, device=plane.device)
    i, n = idx.long()[:, None], n_tok.long()[:, None]
    if window > 0:
        tgt = (i + t) % S
        win = (t < n) & (t >= n - S)  # ring: last S positions win
    else:
        tgt = i + t
        win = (t < n) & (tgt < S)
    rows = torch.arange(B, device=plane.device)[:, None] * S
    _put_rows(_plane_rows(plane), (rows + tgt).reshape(-1),
              chunk.reshape(K, B * C, -1), win.reshape(-1))


def _cache_entry_pos(slots: int, idx: torch.Tensor,
                     window: int) -> torch.Tensor:
    """(B,) chunk starts -> (B, slots) absolute positions held by cache
    slots BEFORE the chunk is written (positions < idx); empty / future
    slots get the FAR sentinel."""
    slot_ids = torch.arange(slots, device=idx.device)
    last = idx.long()[:, None] - 1
    if window > 0:
        pos = last - ((last - slot_ids) % slots)
    else:
        pos = slot_ids.expand(idx.shape[0], slots)
    return torch.where((pos >= 0) & (pos <= last), pos, FAR)


def _chunk_pos(idx, n_tok, C):
    """-> (q positions (B, C), key positions of the chunk (B, C))."""
    t = torch.arange(C, device=idx.device)
    q_pos = idx.long()[:, None] + t
    return q_pos, torch.where(t < n_tok.long()[:, None], q_pos, FAR)


def gqa_prefill(params: dict, x: torch.Tensor, cache: dict,
                idx: torch.Tensor, n_tok: torch.Tensor, a: AttnConfig,
                cfg: ModelConfig, window: int,
                theta: float) -> torch.Tensor:
    """Multi-token prefill over per-slot planes.  x (K, B, C, d) chunk at
    positions idx..idx+C-1 per row; n_tok (B,) valid tokens (the tail is
    padding: masked out of attention and never written).  Queries attend
    over the pre-existing cache plus the chunk, then the chunk's K/V land
    in the cache in place.  -> (K, B, C, d)."""
    K, B, C, _ = x.shape
    q_pos, c_pos = _chunk_pos(idx, n_tok, C)
    q, k, v = _qkv(params, x, a, cfg, q_pos, theta)
    S = cache["k"].shape[2]
    k_pos = torch.cat([_cache_entry_pos(S, idx, window), c_pos], 1)
    k_all = torch.cat([_fold(cache["k"]), _fold(k)], 1)
    v_all = torch.cat([_fold(cache["v"]), _fold(v)], 1)
    o = ops.flash_attention(*_paired(_fold(q), k_all, v_all), causal=True,
                            window=window,
                            scale=1.0 / math.sqrt(a.head_dim),
                            q_pos=_rows(q_pos, K).int(),
                            k_pos=_rows(k_pos, K).int())
    chunk_cache_write(cache["k"], k, idx, n_tok, window)
    chunk_cache_write(cache["v"], v, idx, n_tok, window)
    return _out(params, o, K, B)


# ---------------------------------------------------------------------------
# paged KV pool (serving): fixed-size pages + per-slot page table
# ---------------------------------------------------------------------------
# A paged layer's planes are (K, count, n_pages, page, Hkv, dh) in the
# pool.  The functions below see one layer's pages with members and
# layers folded into the page axis, (K*count*n_pages, page, Hkv, dh) — a
# view of the whole plane, no copy — and a (K, B, P) page table already
# mapped into that global id space (transformer.global_table), so one
# kernel launch serves all K members.  Writes take a table whose
# unallocated entries are >= the folded page count, and drop there;
# reads take one whose unallocated entries point at the last page of the
# member's own layer (the JAX package's clamp), masked by position.


# -- quantized pages --------------------------------------------------------
# kv_dtype selects the storage of paged planes only ("f32" keeps the
# model's dtype, the unquantized layout bit for bit).  int8 / fp8 planes
# carry one f32 absmax scale per token and kv head in a sidecar
# `<plane>_scale_pages` with the page axes leading, so every pool helper
# (copy_pages, page_bytes, the folded views) treats a sidecar as it
# treats its plane and a token's write never requantizes its neighbours.

KV_DTYPES = ("f32", "bf16", "int8", "fp8")
_INT8_MAX = 127.0
_FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def kv_quantized(kv_dtype: str) -> bool:
    return kv_dtype in ("int8", "fp8")


def kv_storage_dtype(kv_dtype: str, dtype: torch.dtype) -> torch.dtype:
    """Storage dtype of a paged K/V plane under `kv_dtype` ("f32" keeps
    the model's dtype)."""
    if kv_dtype == "f32":
        return dtype
    out = {"bf16": torch.bfloat16, "int8": torch.int8,
           "fp8": torch.float8_e4m3fn}.get(kv_dtype)
    if out is None:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    return out


def kv_quantize(vals: torch.Tensor, qdtype: torch.dtype):
    """(..., d) -> ((..., d) qdtype, (...,) f32 absmax scale), the JAX
    package's steps in its order: an f32 upcast, scale = absmax over the
    trailing axis / Q, v / max(scale, 1e-30), for int8 round half to
    even and clip to +-127, then the cast.  An all-zero vector quantizes
    to zeros with scale 0.  At the absmax element v / scale may come out
    a hair above 448; the fp8 cast rounds it to 448."""
    v = vals.float()
    integer = not qdtype.is_floating_point
    scale = v.abs().amax(-1) / (_INT8_MAX if integer else _FP8_MAX)
    q = v / scale.clamp_min(1e-30)[..., None]
    if integer:
        q = torch.round(q).clamp(-_INT8_MAX, _INT8_MAX)
    return q.to(qdtype), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of kv_quantize: f32 values."""
    return q.float() * scale[..., None]


def _scale_name(name: str) -> str:
    return name[: -len("_pages")] + "_scale_pages"


def _raw(x: torch.Tensor) -> torch.Tensor:
    """fp8 planes are indexed through their bytes (indexing kernels do
    not all take float8); every other plane as it is."""
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def gqa_paged_cache_init(a: AttnConfig, lead, n_pages: int, page_size: int,
                         dtype, device, kv_dtype: str = "f32") -> dict:
    sdtype = kv_storage_dtype(kv_dtype, dtype)
    shape = (*lead, n_pages, page_size, a.n_kv_heads, a.head_dim)
    c = {"k_pages": torch.zeros(shape, dtype=sdtype, device=device),
         "v_pages": torch.zeros(shape, dtype=sdtype, device=device)}
    if kv_quantized(kv_dtype):
        for name in ("k_scale_pages", "v_scale_pages"):
            c[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device)
    return c


def _scatter_token(pages: torch.Tensor, vals: torch.Tensor,
                   table: torch.Tensor, pos: torch.Tensor) -> None:
    """Write one token per (member, slot) into a paged plane, in place.

    pages (N, page, Hkv, dh) folded pool; vals (K, B, Hkv, dh); table
    (K, B, P) global ids; pos (B,) logical positions.  Slots whose page is
    unallocated, or whose logical page is past the table, drop the write
    (a frozen slot's garbage step, as in the JAX package)."""
    N, page = pages.shape[:2]
    K, B, P = table.shape
    p = pos.long()
    l = p // page
    phys = table.long().gather(
        2, l.clamp(0, P - 1).expand(K, B)[..., None])[..., 0]  # (K, B)
    ok = (l < P)[None] & (phys < N)
    tgt = phys * page + (p % page)[None]
    _put_rows(pages.view(1, N * page, -1), tgt.reshape(-1),
              vals.reshape(1, K * B, -1), ok.reshape(-1))


def _gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(N, page, ...) x (K, B, P) -> (K*B, P*page, ...) logical view.
    Takes the read table (no sentinels past N); callers mask by
    position."""
    N, page = pages.shape[:2]
    K, B, P = table.shape
    out = _raw(pages)[table.long().clamp(0, N - 1)]  # (K, B, P, page, ...)
    return out.view(pages.dtype).reshape(K * B, P * page, *pages.shape[2:])


# Quantize on write, dequantize on read: where the layer's cache holds a
# `<plane>_scale_pages` sidecar the written values are quantized (one
# scale a token and kv head) and the gathered pages dequantized to f32;
# otherwise the plane's dtype is a plain cast (none at kv_dtype "f32").

def paged_write_token(cache: dict, name: str, vals: torch.Tensor,
                      table: torch.Tensor, pos: torch.Tensor) -> None:
    sname = _scale_name(name)
    if sname in cache:
        q, s = kv_quantize(vals, cache[name].dtype)
        _scatter_token(cache[name], q, table, pos)
        _scatter_token(cache[sname], s, table, pos)
    else:
        _scatter_token(cache[name], vals, table, pos)


def paged_gather(cache: dict, name: str, table: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """_gather_pages, dequantized where the plane has a scale sidecar,
    then cast to out_dtype (the compute dtype)."""
    out = _gather_pages(cache[name], table)
    sname = _scale_name(name)
    if sname in cache:
        out = kv_dequantize(out, _gather_pages(cache[sname], table))
    return out if out_dtype is None else out.to(out_dtype)


def chunk_cache_write_paged(pages: torch.Tensor, chunk: torch.Tensor,
                            table: torch.Tensor, idx: torch.Tensor,
                            n_tok: torch.Tensor) -> None:
    """Bulk-write prompt chunks into a paged plane, in place.

    pages (N, page, Hkv, dh) folded pool; chunk (K, B, C, Hkv, dh) holds
    positions idx[b]..idx[b]+n_tok[b]-1 (t >= n_tok is padding and is
    NOT written); table (K, B, P) global ids.  Writes land only at
    positions [idx, idx + n_tok); pages below idx are read, never
    written.  n_tok == 0 writes nothing."""
    N, page = pages.shape[:2]
    K, B, P = table.shape
    C = chunk.shape[2]
    q_pos, _ = _chunk_pos(idx, n_tok, C)             # (B, C)
    l = q_pos // page
    phys = table.long().gather(2, l.clamp(0, P - 1).expand(K, B, C))
    t = torch.arange(C, device=pages.device)
    ok = ((t < n_tok.long()[:, None]) & (l < P))[None] & (phys < N)
    tgt = phys * page + (q_pos % page)[None]
    _put_rows(pages.view(1, N * page, -1), tgt.reshape(-1),
              chunk.reshape(1, K * B * C, -1), ok.reshape(-1))


def paged_write_chunk(cache: dict, name: str, chunk: torch.Tensor,
                      table: torch.Tensor, idx: torch.Tensor,
                      n_tok: torch.Tensor) -> None:
    """chunk_cache_write_paged through the quantize-on-write wrapper.
    Every row writes at its own position, so this is also the JAX
    package's batched paged_write_batch / chunk_scatter_batch (its
    per-slot write takes one row; the port's takes them all)."""
    sname = _scale_name(name)
    if sname in cache:
        q, s = kv_quantize(chunk, cache[name].dtype)
        chunk_cache_write_paged(cache[name], q, table, idx, n_tok)
        chunk_cache_write_paged(cache[sname], s, table, idx, n_tok)
    else:
        chunk_cache_write_paged(cache[name], chunk, table, idx, n_tok)


def gqa_decode_paged(params: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, table: torch.Tensor,
                     read_table: torch.Tensor, a: AttnConfig,
                     cfg: ModelConfig, window: int,
                     theta: float) -> torch.Tensor:
    """One-token decode over the paged pool, every row at its OWN position.

    x (K, B, 1, d); pos (B,); table / read_table (K, B, P) global ids
    for writes / reads (transformer.global_table); cache
    {"k_pages", "v_pages": (N, page, Hkv, dh)} folded pool.  The new
    token's K/V scatter into the slot's current page in place, then one
    kernels/ops.paged_attention call reads all K members' pages.
    -> (K, B, 1, d)."""
    K, B = x.shape[:2]
    q, k, v = _qkv(params, x, a, cfg, pos.long()[:, None], theta)
    paged_write_token(cache, "k_pages", k[:, :, 0], table, pos)
    paged_write_token(cache, "v_pages", v[:, :, 0], table, pos)
    lens = (pos.int() + 1).repeat(K)
    o = ops.paged_attention(_fold(q[:, :, 0]).contiguous(), cache["k_pages"],
                            cache["v_pages"],
                            read_table.reshape(K * B, -1).int()
                            .contiguous(),
                            lens, window=window,
                            scale=1.0 / math.sqrt(a.head_dim),
                            k_scale=cache.get("k_scale_pages"),
                            v_scale=cache.get("v_scale_pages"))
    return _out(params, o[:, None], K, B)


def gqa_prefill_paged(params: dict, x: torch.Tensor, cache: dict,
                      idx: torch.Tensor, n_tok: torch.Tensor,
                      table: torch.Tensor, read_table: torch.Tensor,
                      a: AttnConfig, cfg: ModelConfig,
                      window: int, theta: float) -> torch.Tensor:
    """Multi-token prefill over the paged pool.  x (K, B, C, d) chunks at
    positions idx..idx+C-1 per row; table / read_table (K, B, P) global
    ids for writes / reads (transformer.global_table).  Same
    math as gqa_prefill: queries attend over the gathered pre-existing
    pages plus the chunk, then the chunk's K/V land in the slot's pages
    in place.  -> (K, B, C, d)."""
    K, B, C, _ = x.shape
    q_pos, c_pos = _chunk_pos(idx, n_tok, C)
    q, k, v = _qkv(params, x, a, cfg, q_pos, theta)
    k_cache = paged_gather(cache, "k_pages", read_table, k.dtype)
    v_cache = paged_gather(cache, "v_pages", read_table, v.dtype)
    S = k_cache.shape[1]
    slot_ids = torch.arange(S, device=x.device)
    cache_pos = torch.where(slot_ids < idx.long()[:, None], slot_ids, FAR)
    k_pos = torch.cat([cache_pos, c_pos], 1)
    o = ops.flash_attention(_fold(q), torch.cat([k_cache, _fold(k)], 1),
                            torch.cat([v_cache, _fold(v)], 1), causal=True,
                            window=window,
                            scale=1.0 / math.sqrt(a.head_dim),
                            q_pos=_rows(q_pos, K).int(),
                            k_pos=_rows(k_pos, K).int())
    paged_write_chunk(cache, "k_pages", k, table, idx, n_tok)
    paged_write_chunk(cache, "v_pages", v, table, idx, n_tok)
    return _out(params, o, K, B)


def gqa_verify_paged(params: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, n_tok: torch.Tensor,
                     table: torch.Tensor, read_table: torch.Tensor,
                     a: AttnConfig, cfg: ModelConfig, window: int,
                     theta: float) -> torch.Tensor:
    """Score a C-token chunk for every slot over the paged pool: the
    speculative verify pass.  x (K, B, C, d) chunks at positions pos[b]
    .. pos[b]+C-1; n_tok (B,) valid tokens a row (0 leaves the pool
    untouched).  Scatter, then gather, as the JAX package does: the
    chunk's K/V land in the slot's pages first (quantized on a quantized
    pool), then every query attends over the gathered, dequantized view
    of all P*page positions through the flash kernel, query i of row b at
    position pos[b]+i and key s at s.  Entries past pos[b]+i are stale
    or padding; causality masks them, and a padded query's output
    (i >= n_tok) is discarded by the caller.  -> (K, B, C, d)."""
    K, B, C, _ = x.shape
    q_pos, _ = _chunk_pos(pos, n_tok, C)
    q, k, v = _qkv(params, x, a, cfg, q_pos, theta)
    paged_write_chunk(cache, "k_pages", k, table, pos, n_tok)
    paged_write_chunk(cache, "v_pages", v, table, pos, n_tok)
    kk = paged_gather(cache, "k_pages", read_table, k.dtype)
    vv = paged_gather(cache, "v_pages", read_table, v.dtype)
    k_pos = torch.arange(kk.shape[1], dtype=torch.int32,
                         device=x.device).expand(K * B, -1).contiguous()
    o = ops.flash_attention(_fold(q), kk, vv, causal=True, window=window,
                            scale=1.0 / math.sqrt(a.head_dim),
                            q_pos=_rows(q_pos, K).int(), k_pos=k_pos)
    return _out(params, o, K, B)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): latent-compressed KV
# ---------------------------------------------------------------------------
# The cache holds, per token, the latent c_kv (r = kv_lora_rank features)
# and one rope key k_r (qk_rope_dim) shared by all heads: contiguous
# planes {"c_kv": (K, B, S, r), "k_r": (K, B, S, rope)}, or paged ones
# {"c_kv_pages": (N, page, r), "k_r_pages": (N, page, rope)} folded as
# the GQA pages are.  MLA layers attend over the whole sequence (no
# window), so under paged serving every MLA layer pages.

def _mla_qkv(params, x, a: AttnConfig):
    """x (K, B, T, d) -> (q (K, B, T, H, nope + rope), c_kv (K, B, T, r),
    k_r (K, B, T, rope)), none of them rotated yet."""
    K, B, T, _ = x.shape
    if "q_down" in params:
        q = mm(mm(x, params["q_down"]), params["q_up"])
    else:
        q = mm(x, params["w_q"])
    q = q.reshape(K, B, T, a.n_heads, a.qk_nope_dim + a.qk_rope_dim)
    return q, mm(x, params["kv_down"]), mm(x, params["k_rope"])


def _mla_rope(q, k_r, pos, a: AttnConfig, theta: float):
    """Rotate q's rope features and the shared rope key at positions pos
    (B, T) -> (q_c (K, B, T, H, nope), q_r (..., rope), k_r (K, B, T,
    rope)): the key takes a head axis of 1 through the rotation."""
    q_c, q_r = q[..., :a.qk_nope_dim], q[..., a.qk_nope_dim:]
    q_r = apply_rope(q_r, pos, theta)
    k_r = apply_rope(k_r[..., None, :], pos, theta)[..., 0, :]
    return q_c, q_r, k_r


def _mla_expand(params, c_kv, a: AttnConfig):
    """Latents (K, B, S, r) -> per-head (k_c (K, B, S, H, nope), v (K, B,
    S, H, v))."""
    K, B, S, _ = c_kv.shape
    kv = mm(c_kv, params["kv_up"]).reshape(
        K, B, S, a.n_heads, a.qk_nope_dim + a.v_head_dim)
    return kv[..., :a.qk_nope_dim], kv[..., a.qk_nope_dim:]


def _mla_attend(params, q_c, q_r, c_kv, k_r, q_pos, k_pos, a: AttnConfig):
    """The expanded form: queries (K, B, Tq, H, *) over latents (K, B, S,
    r) and rope keys (K, B, S, rope) at positions q_pos (B, Tq), k_pos
    (B, S), causal, through `attend` -> (K, B, Tq, d)."""
    K, B = q_c.shape[:2]
    k_c, v = _mla_expand(params, c_kv, a)
    k_full = constrain(_fold(torch.cat([k_c, k_r[..., None, :].expand(
        *k_c.shape[:-1], a.qk_rope_dim)], -1)), None, None, "model", None)
    q_full = constrain(_fold(torch.cat([q_c, q_r], -1)),
                       None, None, "model", None)
    v = constrain(_fold(v), None, None, "model", None)
    o = attend(q_full, k_full, v,
               _rows(q_pos, K), _rows(k_pos, K), window=0, causal=True,
               scale=1.0 / math.sqrt(a.qk_nope_dim + a.qk_rope_dim))
    return _out(params, o, K, B)


def mla_absorbed(params: dict, a: AttnConfig):
    """(W_UK (K, r, H, nope), W_UV (K, r, H, v)): kv_up split for the
    absorbed decode, as VIEWS of kv_up (a reshape, then slices), so no
    copy is made and the param tree keeps its leaves."""
    w = params["kv_up"]
    w = w.view(*w.shape[:-1], a.n_heads, a.qk_nope_dim + a.v_head_dim)
    return w[..., :a.qk_nope_dim], w[..., a.qk_nope_dim:]


def mla_apply(params: dict, x: torch.Tensor, a: AttnConfig,
              cfg: ModelConfig, positions: torch.Tensor,
              theta: float) -> torch.Tensor:
    """x (K, B, T, d), positions (B, T) -> (K, B, T, d): the expanded
    form through `attend`, forward and training alike (autograd
    differentiates it), as the JAX package's mla_apply."""
    q, c_kv, k_r = _mla_qkv(params, x, a)
    q_c, q_r, k_r = _mla_rope(q, k_r, positions, a, theta)
    return _mla_attend(params, q_c, q_r, c_kv, k_r, positions, positions, a)


def mla_cache_init(a: AttnConfig, lead, batch: int, max_seq: int, dtype,
                   device) -> dict:
    # the latent and the rope key, not per-head K/V: MLA's point
    return {"c_kv": torch.zeros(*lead, batch, max_seq, a.kv_lora_rank,
                                dtype=dtype, device=device),
            "k_r": torch.zeros(*lead, batch, max_seq, a.qk_rope_dim,
                               dtype=dtype, device=device)}


def mla_decode(params: dict, x: torch.Tensor, cache: dict,
               idx: torch.Tensor, a: AttnConfig, cfg: ModelConfig,
               theta: float) -> torch.Tensor:
    """One-token decode over contiguous latent planes, every row at its
    OWN position (the JAX package's row vmap of mla_decode): the new
    latent lands at idx in place, then the whole plane is expanded and
    attended, entries past idx masked.  x (K, B, 1, d); idx (B,) ->
    (K, B, 1, d)."""
    B = x.shape[1]
    pos = idx.long()[:, None]
    q, c_kv, k_r = _mla_qkv(params, x, a)
    q_c, q_r, k_r = _mla_rope(q, k_r, pos, a, theta)
    rows = torch.arange(B, device=x.device)
    _write_token(cache["c_kv"], c_kv[:, :, 0], rows, pos[:, 0])
    _write_token(cache["k_r"], k_r[:, :, 0], rows, pos[:, 0])
    S = cache["c_kv"].shape[2]
    slot_ids = torch.arange(S, device=x.device)
    k_pos = torch.where(slot_ids <= pos, slot_ids, FAR)
    return _mla_attend(params, q_c, q_r, cache["c_kv"], cache["k_r"], pos,
                       k_pos, a)


def mla_prefill(params: dict, x: torch.Tensor, cache: dict,
                idx: torch.Tensor, n_tok: torch.Tensor, a: AttnConfig,
                cfg: ModelConfig, theta: float) -> torch.Tensor:
    """Multi-token prefill over contiguous latent planes: the chunk's
    latents land first (positions idx..idx+n_tok-1, in place), then the
    expanded plane is attended, entries past idx+n_tok masked, as the
    JAX package's mla_prefill.  x (K, B, C, d) -> (K, B, C, d)."""
    C = x.shape[2]
    q_pos, _ = _chunk_pos(idx, n_tok, C)
    q, c_kv, k_r = _mla_qkv(params, x, a)
    q_c, q_r, k_r = _mla_rope(q, k_r, q_pos, a, theta)
    for name, new in (("c_kv", c_kv), ("k_r", k_r)):
        chunk_cache_write(cache[name].unsqueeze(-2), new.unsqueeze(-2), idx,
                          n_tok, 0)
    S = cache["c_kv"].shape[2]
    slot_ids = torch.arange(S, device=x.device)
    k_pos = torch.where(slot_ids < (idx.long() + n_tok.long())[:, None],
                        slot_ids, FAR)
    return _mla_attend(params, q_c, q_r, cache["c_kv"], cache["k_r"], q_pos,
                       k_pos, a)


def mla_paged_cache_init(a: AttnConfig, lead, n_pages: int, page_size: int,
                         dtype, device, kv_dtype: str = "f32") -> dict:
    """The latent pages in kv_dtype's storage.  Under int8 / fp8 the rope
    keys stay in the model's dtype (they are rope/r of the bytes and
    feed the kernel as its unquantized k_extra block) and the latent
    takes one scale a token, "c_kv_scale_pages" (n_pages, page)."""
    sdtype = kv_storage_dtype(kv_dtype, dtype)
    quant = kv_quantized(kv_dtype)
    c = {"c_kv_pages": torch.zeros(*lead, n_pages, page_size,
                                   a.kv_lora_rank, dtype=sdtype,
                                   device=device),
         "k_r_pages": torch.zeros(*lead, n_pages, page_size, a.qk_rope_dim,
                                  dtype=dtype if quant else sdtype,
                                  device=device)}
    if quant:
        c["c_kv_scale_pages"] = torch.zeros(*lead, n_pages, page_size,
                                            dtype=torch.float32,
                                            device=device)
    return c


def mla_decode_paged(params: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, table: torch.Tensor,
                     read_table: torch.Tensor, a: AttnConfig,
                     cfg: ModelConfig, theta: float) -> torch.Tensor:
    """MLA one-token decode over the paged latent pool in the ABSORBED
    form, every row at its own position.

    The new token's latent and rope key scatter into the slot's pages in
    place.  W_UK folds into the queries (q_lat = q_c . W_UK, so the
    latent is the key) and W_UV into the output (the latent is the
    value), so one kernels/ops.paged_attention call over all K members'
    rows reads the latent pages as keys and values, dk = dv = r, with
    the rope keys as `k_extra`: no expansion of the gathered sequence.
    x (K, B, 1, d); pos (B,); table / read_table (K, B, P) global ids.
    -> (K, B, 1, d)."""
    K, B = x.shape[:2]
    p2 = pos.long()[:, None]
    q, c_kv, k_r = _mla_qkv(params, x, a)
    q_c, q_r, k_r = _mla_rope(q, k_r, p2, a, theta)
    paged_write_token(cache, "c_kv_pages", c_kv[:, :, 0], table, pos)
    paged_write_token(cache, "k_r_pages", k_r[:, :, 0], table, pos)
    w_uk, w_uv = mla_absorbed(params, a)
    q_lat = torch.einsum("kbhn,krhn->kbhr", q_c[:, :, 0], w_uk)
    q_abs = torch.cat([q_lat, q_r[:, :, 0]], -1)     # (K, B, H, r + rope)
    latent = cache["c_kv_pages"][:, :, None]          # one "kv head"
    # a quantized latent's one scale plane scales it as keys and values
    c_scale = cache.get("c_kv_scale_pages")
    c_scale = None if c_scale is None else c_scale[:, :, None]
    o_lat = ops.paged_attention(
        _fold(q_abs).contiguous(), latent, latent,
        read_table.reshape(K * B, -1).int().contiguous(),
        (pos.int() + 1).repeat(K),
        scale=1.0 / math.sqrt(a.qk_nope_dim + a.qk_rope_dim),
        k_scale=c_scale, v_scale=c_scale,
        k_extra=cache["k_r_pages"][:, :, None])       # (K*B, H, r)
    o = torch.einsum("kbhr,krhv->kbhv",
                     o_lat.view(K, B, a.n_heads, -1), w_uv)
    return mm(o.reshape(K, B, 1, -1), params["w_o"])


def mla_prefill_paged(params: dict, x: torch.Tensor, cache: dict,
                      idx: torch.Tensor, n_tok: torch.Tensor,
                      table: torch.Tensor, read_table: torch.Tensor,
                      a: AttnConfig, cfg: ModelConfig,
                      theta: float) -> torch.Tensor:
    """Multi-token MLA prefill over the paged latent pool: the chunk's
    latents scatter first, then the slot's pages are gathered
    (dequantized), expanded and attended with entries past idx+n_tok
    masked (the JAX package's mla_prefill_paged).  Every row takes its
    own position, so this is also the JAX package's mla_verify_paged
    (speculative verify): its causal-only bias differs from this mask on
    padded queries alone, whose outputs are discarded.  x (K, B, C, d)
    -> (K, B, C, d)."""
    C = x.shape[2]
    q_pos, _ = _chunk_pos(idx, n_tok, C)
    q, c_kv, k_r = _mla_qkv(params, x, a)
    q_c, q_r, k_r = _mla_rope(q, k_r, q_pos, a, theta)
    paged_write_chunk(cache, "c_kv_pages", c_kv, table, idx, n_tok)
    paged_write_chunk(cache, "k_r_pages", k_r, table, idx, n_tok)
    K, B = x.shape[:2]
    lat = paged_gather(cache, "c_kv_pages", read_table, c_kv.dtype)
    rop = paged_gather(cache, "k_r_pages", read_table, k_r.dtype)
    S = lat.shape[1]
    slot_ids = torch.arange(S, device=x.device)
    k_pos = torch.where(slot_ids < (idx.long() + n_tok.long())[:, None],
                        slot_ids, FAR)
    return _mla_attend(params, q_c, q_r, lat.view(K, B, S, -1),
                       rop.view(K, B, S, -1), q_pos, k_pos, a)


# ---------------------------------------------------------------------------
# cross-attention (whisper's decoder over the encoder's frames)
# ---------------------------------------------------------------------------

def cross_attn_init(gen, lead, cfg: ModelConfig, a: AttnConfig,
                    dtype) -> dict:
    d = cfg.d_model
    return {
        "w_cross_q": dense_init(gen, lead, (d, a.n_heads * a.head_dim),
                                dtype),
        "w_k": dense_init(gen, lead, (d, a.n_kv_heads * a.head_dim), dtype),
        "w_v": dense_init(gen, lead, (d, a.n_kv_heads * a.head_dim), dtype),
        "w_o": dense_init(gen, lead, (a.n_heads * a.head_dim, d), dtype),
    }


def cross_attn_apply(params: dict, x: torch.Tensor, enc: torch.Tensor,
                     a: AttnConfig, flash: bool) -> torch.Tensor:
    """x (K, B, T, d) decoder tokens over enc (K, B, S, d) encoder frames,
    every query seeing every frame (no mask) -> (K, B, T, d).  The frames
    are projected through w_k / w_v on every call, as the JAX package
    does.  flash=True (apply's forward-only route, the encoder's
    consumers at prefill) goes through kernels/ops.flash_attention,
    non-causal, T queries over S frames; flash=False (training, and the
    one-token decode, as the port's contiguous gqa_decode) takes
    `attend`."""
    K, B, T, _ = x.shape
    S = enc.shape[2]
    q = _heads(mm(x, params["w_cross_q"]), a.n_heads, a.head_dim,
               _head_spec(a.n_heads, x))
    k, v = (_heads(mm(enc, params[w]), a.n_kv_heads, a.head_dim,
                   _head_spec(a.n_kv_heads, x)) for w in ("w_k", "w_v"))
    scale = 1.0 / math.sqrt(a.head_dim)
    if flash:
        o = ops.flash_attention(*_paired(_fold(q), _fold(k), _fold(v)),
                                causal=False, scale=scale)
    else:
        o = attend(_fold(q), _fold(k), _fold(v),
                   torch.arange(T, device=x.device),
                   torch.arange(S, device=x.device), window=0, causal=False,
                   scale=scale)
    return _out(params, o, K, B)
