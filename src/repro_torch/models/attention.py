"""GQA attention: full-sequence apply, ring-cache decode and prefill, and
the paged-pool decode and prefill of the serving engine.

Shapes carry the member axis K first: x is (K, B, T, d).  The core math
(`attend`) folds members into the batch, (K*B, T, H, dh).  Positions are
per row, (B,) or (B, T), shared by all members.

Cache planes are updated IN PLACE: the JAX package returns new planes and
relies on buffer donation; here the functions write through the views
they are given (so a slot row taken with kv_cache.slot_row writes into
the pool) and return only the attention output.

Kernels: the full-sequence forward (`gqa_apply`) and both chunked
prefills (`gqa_prefill` over a ring, `gqa_prefill_paged` over gathered
pages, each plus the chunk) go through kernels/ops.flash_attention, one
call per layer with the K members folded into its rows; paged decode
reads go through kernels/ops.paged_attention.  On the card both are
hand-written CUDA kernels.  Ring-layer decode (`gqa_decode`) stays on
`attend`, whose two paths are numerically identical: `_attend_dense`
materializes the score matrix, `_attend_chunked` loops over KV chunks
with an online-softmax accumulator.

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
    if a.kind != "gqa":
        raise NotImplementedError(
            f"attention kind {a.kind!r} is not ported yet (MLA comes with "
            f"the deepseek-v2 slice)")
    d = cfg.d_model
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


def attend(q, k, v, q_pos, k_pos, *, window: int, causal: bool,
           scale: float, force_dense: Optional[bool] = None) -> torch.Tensor:
    """Dispatch dense vs chunked on KV length.  Positions are (T,) shared
    by every row or (N, T) per row."""
    Tk = k.shape[1]
    dense = Tk <= ATTN_CHUNK if force_dense is None else force_dense
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


def _qkv(params, x, a: AttnConfig, cfg: ModelConfig, pos, theta):
    """x (K, B, T, d), pos (B, T) -> rotated q (K,B,T,H,dh), k, v."""
    K, B, T, _ = x.shape
    q = mm(x, params["w_q"]).reshape(K, B, T, a.n_heads, a.head_dim)
    k = mm(x, params["w_k"]).reshape(K, B, T, a.n_kv_heads, a.head_dim)
    v = mm(x, params["w_v"]).reshape(K, B, T, a.n_kv_heads, a.head_dim)
    q, k = _maybe_qknorm(params, q, k, cfg.norm_eps)
    if a.use_rope:
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
    return q, k, v


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(K, B, ...) -> (K*B, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _out(params, o: torch.Tensor, K: int, B: int) -> torch.Tensor:
    return mm(o.reshape(K, B, o.shape[1], -1), params["w_o"])


def gqa_apply(params: dict, x: torch.Tensor, a: AttnConfig,
              cfg: ModelConfig, positions: torch.Tensor, window: int,
              theta: float, causal: bool = True) -> torch.Tensor:
    """x (K, B, T, d), positions (B, T) -> (K, B, T, d).  positions are
    0..T-1 in every row (transformer.apply's), so the attention mask is
    the flash kernel's top-left one."""
    K, B, T, _ = x.shape
    q, k, v = _qkv(params, x, a, cfg, positions, theta)
    o = ops.flash_attention(_fold(q), _fold(k), _fold(v), causal=causal,
                            window=window,
                            scale=1.0 / math.sqrt(a.head_dim))
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
    cache["k"][:, rows, slot] = k[:, :, 0]
    cache["v"][:, rows, slot] = v[:, :, 0]
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
    o = ops.flash_attention(_fold(q), k_all, v_all, causal=True,
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


def gqa_paged_cache_init(a: AttnConfig, lead, n_pages: int, page_size: int,
                         dtype, device) -> dict:
    shape = (*lead, n_pages, page_size, a.n_kv_heads, a.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


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
    out = pages[table.long().clamp(0, N - 1)]      # (K, B, P, page, ...)
    return out.reshape(K * B, P * page, *pages.shape[2:])


def paged_write_token(cache: dict, name: str, vals: torch.Tensor,
                      table: torch.Tensor, pos: torch.Tensor) -> None:
    _scatter_token(cache[name], vals, table, pos)


def paged_gather(cache: dict, name: str, table: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    out = _gather_pages(cache[name], table)
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
                            scale=1.0 / math.sqrt(a.head_dim))
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
