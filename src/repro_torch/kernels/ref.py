"""Plain PyTorch versions of the hand-written kernels (their oracles).

Written for clarity and numerical fidelity, not speed.  On a CPU tensor
kernels/ops.py dispatches here; on the card chip_smoke.py holds each
CUDA kernel against its plain version on the same inputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -2.0 ** 30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None,
              q_pos: Optional[torch.Tensor] = None,
              k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked GQA attention (the flash kernel's oracle), all math in f32.

    q (N, T, H, dh), k/v (N, S, Hkv, dh), H a multiple of Hkv: query head
    h*g + i reads kv head h.  -> (N, T, H, dh) in q's dtype.

    With no positions it is the TPU kernel's top-left contract: query t
    sits at position t and key s at s.  With q_pos (N, T) and k_pos
    (N, S) it applies the models' mask: a key at a negative position
    (the empty-slot sentinel) is never attended, causal means k_pos <=
    q_pos, and window > 0 means k_pos > q_pos - window.  A query row
    with no valid key gets the uniform average of all S values (every
    score is NEG_INF); callers discard such rows.
    """
    ok = attention_mask(q.shape[0], q.shape[1], k.shape[1], causal, window,
                        q_pos, k_pos, q.device)
    return _masked_attention(q, k, v, ok[:, None, None], scale)


def attention_mask(N: int, T: int, S: int, causal: bool = True,
                   window: int = 0, q_pos: Optional[torch.Tensor] = None,
                   k_pos: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """(N, T, S) bool: the (query, key) pairs ref.attention keeps."""
    if q_pos is None:
        q_pos = torch.arange(T, device=device).expand(N, T)
    if k_pos is None:
        k_pos = torch.arange(S, device=device).expand(N, S)
    qp, kp = q_pos.long()[:, :, None], k_pos.long()[:, None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    return ok.expand(N, T, S)


def _masked_attention(q, k, v, ok, scale):
    """Softmax attention, q (N, T, H, dh) over k/v (N, S, Hkv, dh) where
    ok (N, Hkv or 1, g or 1, T, S) keeps a pair; all math in f32."""
    N, T, H, dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else dh ** -0.5
    qf = q.float().reshape(N, T, Hkv, g, dh)
    s = torch.einsum("nqhgd,nkhd->nhgqk", qf, k.float()) * scale
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("nhgqk,nkhd->nqhgd", p, v.float())
    return o.reshape(N, T, H, v.shape[-1]).to(q.dtype)


def flash_tile_live(N: int, T: int, S: int, g: int, bq: int, bk: int,
                    causal: bool = True, window: int = 0,
                    q_pos: Optional[torch.Tensor] = None,
                    k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Twin of the flash kernel's tile-skip predicate (`tile_live` in
    csrc/flash_attention.cu).  The kernel's block holds bq of a kv
    head's g*T group-major query rows (row r is time r % T) and walks the
    keys in tiles of bk.  -> (N, ceil(g*T / bq), ceil(S / bk)) bool: False
    where the kernel skips the tile, because no key of it is at a
    position >= 0 with (causal) position <= the block's largest query
    position and (window) position > its smallest minus the window."""
    dev = q_pos.device if q_pos is not None else None
    if q_pos is None:
        q_pos = torch.arange(T).expand(N, T)
        k_pos = torch.arange(S).expand(N, S)
    rows = g * T
    nq, nk = -(-rows // bq), -(-S // bk)
    t = torch.arange(nq * bq, device=dev) % T
    t[rows:] = t[0]              # rows past the end add nothing
    qp = q_pos.long()[:, t].reshape(N, nq, bq)
    qmin, qmax = qp.min(-1).values, qp.max(-1).values
    kp = torch.full((N, nk * bk), -1, dtype=torch.long, device=dev)
    kp[:, :S] = k_pos.long()
    kp = kp.reshape(N, 1, nk, bk)
    ok = (kp >= 0).expand(N, nq, nk, bk)    # every block, masked or not
    if causal:
        ok = ok & (kp <= qmax[:, :, None, None])
    if window > 0:
        ok = ok & (kp > qmin[:, :, None, None] - window)
    return ok.any(-1)


def attention_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int, bk: int, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    q_pos: Optional[torch.Tensor] = None,
                    k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ref.attention with the keys of every tile the flash kernel skips
    (flash_tile_live) masked out of each query row of that block; a
    row's result must not change wherever it has a valid key."""
    N, T, H, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    ok = attention_mask(N, T, S, causal, window, q_pos, k_pos, q.device)
    live = flash_tile_live(N, T, S, g, bq, bk, causal, window, q_pos,
                           k_pos).to(q.device)
    r = torch.arange(g * T, device=q.device)
    keys = torch.arange(S, device=q.device)
    keep = live[:, r // bq][:, :, keys // bk]       # (N, g*T, S)
    keep = keep.reshape(N, 1, g, T, S)
    return _masked_attention(q, k, v, ok[:, None, None] & keep, scale)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lens: torch.Tensor, window: int = 0,
                    scale: Optional[float] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    k_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over a paged KV pool (the kernel's oracle).

    q:       (B, H, dk[+dr])       one query per slot (the decode step)
    k_pages: (n_pages, page, Hkv, dk) physical page pool
    v_pages: (n_pages, page, Hkv, dv)
    table:   (B, P) int            per-slot logical->physical page ids;
                                   entries >= n_pages mean "unallocated"
    lens:    (B,) int              valid entries per slot (incl. the
                                   token written this step)
    -> (B, H, dv) in q's dtype.

    Quantized pools pass k_scale/v_scale (n_pages, page, Hkv) per-token
    scales: pages dequantize to f32 (value * scale) right after the
    gather.  k_extra (n_pages, page, Hkv, dr) is an unquantized extra
    key-feature block (absorbed-MLA rope keys) concatenated after the
    main block; q then carries dk + dr features.

    The gather materializes every slot's P*page logical entries; entries
    past `lens` are masked to NEG_INF before the softmax, so they
    contribute exactly 0.
    """
    B, H, dkq = q.shape
    n_pages, page, Hkv, dk = k_pages.shape
    dv = v_pages.shape[-1]
    g = H // Hkv
    P = table.shape[1]
    S = P * page
    scale = scale if scale is not None else dkq ** -0.5
    t = table.long().clamp(0, n_pages - 1)
    # (B, P, page, Hkv, d) -> (B, S, Hkv, d), logical position order
    k = k_pages[t].reshape(B, S, Hkv, dk).float()
    v = v_pages[t].reshape(B, S, Hkv, dv).float()
    if k_scale is not None:
        k = k * k_scale[t].reshape(B, S, Hkv)[..., None].float()
    if v_scale is not None:
        v = v * v_scale[t].reshape(B, S, Hkv)[..., None].float()
    if k_extra is not None:
        dr = k_extra.shape[-1]
        ke = k_extra[t].reshape(B, S, Hkv, dr).float()
        k = torch.cat([k, ke], -1)
    kp = torch.arange(S, device=q.device)
    ln = lens.long()
    ok = kp[None, :] < ln[:, None]
    if window > 0:
        ok &= kp[None, :] > (ln[:, None] - 1 - window)
    bias = torch.where(ok, 0.0, NEG_INF).float()  # (B, S)
    qf = q.float().reshape(B, Hkv, g, dkq)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k) * scale
    s = s + bias[:, None, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return o.reshape(B, H, dv).to(q.dtype)


def paged_split_pages(lens: torch.Tensor, page: int, window: int,
                      n_split: int) -> torch.Tensor:
    """Twin of the paged kernel's division of a row's live pages over
    its n_split blocks.  Live pages are [first, ceil(len / page)), first
    the page of the window's oldest position; split s takes [first + s *
    n // n_split, first + (s + 1) * n // n_split) with n the live count.
    -> (B, n_split, 2) int64 [lo, hi) page ranges (lo == hi: no page)."""
    ln = lens.long()
    live = (ln + page - 1) // page
    first = torch.zeros_like(ln)
    if window > 0:
        first = torch.where(ln - window > 0, (ln - window) // page, first)
    n = (live - first).clamp(min=0)
    s = torch.arange(n_split + 1, device=ln.device)
    edge = first[:, None] + s[None] * n[:, None] // n_split
    return torch.stack([edge[:, :-1], edge[:, 1:]], -1)


def paged_attention_split(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, table: torch.Tensor,
                          lens: torch.Tensor, n_split: int, window: int = 0,
                          scale: Optional[float] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          k_extra: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain two-pass twin of the split paged kernel (for tests): each
    split's partial (m, l, acc) over its pages (paged_split_pages), in
    f32, then the combine of csrc/attention_combine.cuh.  Same contract
    and result as paged_attention."""
    B, H, dkq = q.shape
    n_pages, page, Hkv, dk = k_pages.shape
    dv = v_pages.shape[-1]
    g = H // Hkv
    scale = scale if scale is not None else dkq ** -0.5
    t = table.long().clamp(0, n_pages - 1)
    S = t.shape[1] * page
    k = k_pages[t].reshape(B, S, Hkv, dk).float()
    v = v_pages[t].reshape(B, S, Hkv, dv).float()
    if k_scale is not None:
        k = k * k_scale[t].reshape(B, S, Hkv)[..., None].float()
    if v_scale is not None:
        v = v * v_scale[t].reshape(B, S, Hkv)[..., None].float()
    if k_extra is not None:
        k = torch.cat([k, k_extra[t].reshape(B, S, Hkv, -1).float()], -1)
    qf = q.float().reshape(B, Hkv, g, dkq)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k) * scale
    pos = torch.arange(S, device=q.device)
    ln = lens.long()[:, None]
    ok = pos[None] < ln
    if window > 0:
        ok &= pos[None] > ln - 1 - window
    rng = paged_split_pages(lens, page, window, n_split)   # (B, ns, 2)
    pg = (pos // page)[None, None]
    mine = (pg >= rng[..., :1]) & (pg < rng[..., 1:])        # (B, ns, S)
    m = torch.full((B, n_split, Hkv, g), NEG_INF, device=q.device)
    l = torch.zeros(B, n_split, Hkv, g, device=q.device)
    acc = torch.zeros(B, n_split, Hkv, g, dv, device=q.device)
    for i in range(n_split):          # pass 1: each split's partial
        if not mine[:, i].any():
            continue
        sc = torch.where((ok & mine[:, i])[:, None, None], s, -float("inf"))
        mi = torch.maximum(sc.amax(-1), torch.tensor(NEG_INF))
        p = torch.exp(sc - mi[..., None])
        m[:, i], l[:, i] = mi, p.sum(-1)
        acc[:, i] = torch.einsum("bhgk,bkhd->bhgd", p, v)
    big = m.amax(1, keepdim=True)     # pass 2: the combine
    w = torch.exp(m - big)
    o = (acc * w[..., None]).sum(1) / (l * w).sum(1).clamp(min=1e-30)[..., None]
    return o.reshape(B, H, dv).to(q.dtype)


def distill_loss_parts(logits: torch.Tensor, labels: torch.Tensor,
                       pseudo: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, V) logits, (N,) int labels, (N, V) pseudo-label probs ->
    per-row (lse, gold, dot) in f32; the Eqn-9 loss of row i is
    (1+lam)*lse_i - gold_i - lam*dot_i.  A label outside [0, V) (-1
    pads) hits no column: its gold is 0, as in the fused kernel."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    y = labels.long()
    hit = (y >= 0) & (y < lg.shape[-1])
    gold = lg.gather(-1, torch.where(hit, y, 0)[..., None])[..., 0]
    gold = torch.where(hit, gold, 0.0)
    dot = (pseudo.float() * lg).sum(-1)
    return lse, gold, dot


def distill_loss(logits: torch.Tensor, labels: torch.Tensor,
                 pseudo: torch.Tensor, lam) -> torch.Tensor:
    """Eqn 9, mean over rows: CE(z, y) + lam * CE(z, pseudo) for
    pseudo-labels that sum to 1 (the fused kernel's oracle)."""
    lse, gold, dot = distill_loss_parts(logits, labels, pseudo)
    return ((1.0 + lam) * lse - gold - lam * dot).mean()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 wkv recurrence, sequential (the wkv6 kernel's oracle).

    r/k/v/log_w (N, T, H, dh) f32; s0 (N, H, dh, dh) f32 in [key,
    value] order; u (H, dh), or (K, H, dh) with K | N for rows that fold
    K members (row n reads member n // (N / K)'s u).  Per token t:
        y_t = r_t (S + u k_tᵀ v_t);  S <- exp(log_w_t) ∘ S + k_tᵀ v_t
    -> (y (N, T, H, dh), s_T (N, H, dh, dh))."""
    N, T, H, dh = r.shape
    uf = u.float().reshape(-1, H, dh)
    uf = uf.repeat_interleave(N // uf.shape[0], dim=0)[..., None]  # (N,H,dh,1)
    S = s0.float().clone()
    ys = []
    for t in range(T):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        kv = torch.einsum("nhk,nhv->nhkv", kt, vt)
        ys.append(torch.einsum("nhk,nhkv->nhv", rt, S + uf * kv))
        S = S * torch.exp(log_w[:, t].float())[..., None] + kv
    y = torch.stack(ys, 1) if ys else r.new_zeros(N, 0, H, dh)
    return y, S


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                 chunk: int = 16, sub: int = 8
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the chunked wkv6 kernel (for tests): ref.wkv6's
    contract and result, computed as csrc/wkv6.cu computes it.

    T is cut into chunks of `chunk` tokens (the last padded with r = k =
    v = log_w = 0, which are state no-ops), each chunk into sub-blocks of
    `sub`.  With w = exp(log_w) <= 1 the decay between two tokens is a
    product of w's, so nothing overflows whatever the decays: with m[s]
    the sum of log_w before sub-block s, the factors exp(la_p[t] - m[s])
    and exp(m[s+1] - la[j]) through the sub-block's ends are the
    products of w inside it before t and after j:
      Q[t]  = r[t] prod_{s0 <= q < t} w[q]      Rin[t] = Q[t] E[s(t)]
      Kf[j] = k[j] prod_{j < q < s0 + sub} w[q]  (s0: the sub-block's
      G[s]  = prod of w over sub-block s          first token)
      E[s]  = G[0] ... G[s - 1]                  (E[0] = 1)
      A[t, j] = Q[t] . (G[s(j)+1] ... G[s(t)-1] Kf[j])    s(j) < s(t)
      A[t, j] = sum_i r[t] k[j] prod_{j < q < t} w[q]     j < t, one
                sub-block (the diagonal blocks' pairwise decays)
      A[t, t] = r[t] . (u k[t])                           (the bonus)
      y  = A v + Rin S
      S <- (... (S G[0] + Kf[b0]ᵀ v[b0]) G[1] + ...) + Kf[bl]ᵀ v[bl]
    (b0 ... bl the sub-blocks).  -> (y (N, T, H, dh), s_T (N, H, dh,
    dh))."""
    N, T, H, dh = r.shape
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is not a multiple of sub {sub}")
    uf = u.float().reshape(-1, H, dh)
    uf = uf.repeat_interleave(N // uf.shape[0], dim=0)      # (N, H, dh)
    nc = -(-T // chunk)
    pad = nc * chunk - T

    def heads(x):       # (N, T, H, dh) -> (N, H, nc, chunk, dh), f32
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(N, nc, chunk, H, dh).permute(0, 3, 1, 2, 4)

    rc, kc, vc, lwc = map(heads, (r, k, v, log_w))
    ns = chunk // sub
    S = s0.float().clone()                                   # (N, H, dh, dh)
    ys = []
    for c in range(nc):
        rb, kb, vb = rc[:, :, c], kc[:, :, c], vc[:, :, c]
        w = torch.exp(lwc[:, :, c]).reshape(N, H, ns, sub, dh)
        one = torch.ones_like(w[:, :, :, :1])
        pre = torch.cumprod(torch.cat([one, w[:, :, :, :-1]], 3), 3)
        suf = torch.cumprod(torch.cat([one, w.flip(3)[:, :, :, :-1]], 3),
                            3).flip(3)
        G = pre[:, :, :, -1] * w[:, :, :, -1]               # (N, H, ns, dh)
        E = torch.cumprod(torch.cat([one[:, :, :1, 0], G[:, :, :-1]], 2), 2)
        Q = rb * pre.reshape(rb.shape)
        Rin = Q * E.repeat_interleave(sub, 2)
        Kf = kb * suf.reshape(kb.shape)
        w = w.reshape(rb.shape)
        A = rb.new_zeros(N, H, chunk, chunk)
        for tb in range(ns):
            rows = slice(tb * sub, (tb + 1) * sub)
            for b in range(tb):
                cols = slice(b * sub, (b + 1) * sub)
                cf = torch.prod(G[:, :, b + 1:tb], 2)[:, :, None]
                A[:, :, rows, cols] = torch.einsum(
                    "nhtd,nhjd->nhtj", Q[:, :, rows], Kf[:, :, cols] * cf)
            for t in range(tb * sub, (tb + 1) * sub):
                A[:, :, t, t] = (rb[:, :, t] * uf * kb[:, :, t]).sum(-1)
                g = rb[:, :, t]
                for j in range(t - 1, tb * sub - 1, -1):
                    A[:, :, t, j] = (g * kb[:, :, j]).sum(-1)
                    g = g * w[:, :, j]
        ys.append(torch.einsum("nhtj,nhjv->nhtv", A, vb)
                  + torch.einsum("nhtk,nhkv->nhtv", Rin, S))
        for s in range(ns):
            cols = slice(s * sub, (s + 1) * sub)
            S = S * G[:, :, s, :, None] + torch.einsum(
                "nhjk,nhjv->nhkv", Kf[:, :, cols], vb[:, :, cols])
    if not ys:
        return r.new_zeros(N, 0, H, dh), S
    y = torch.stack(ys, 2).reshape(N, H, nc * chunk, dh)[:, :, :T]
    return y.permute(0, 2, 1, 3), S


def ssm_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba selective scan h_t = a_t * h_{t-1} + b_t, sequential (the
    ssm_scan kernel's oracle).  a/b (N, T, D, Ns), h0 (N, D, Ns).
    -> (hs (N, T, D, Ns) in a's dtype, h_T (N, D, Ns) f32)."""
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        hs.append(h)
    out = torch.stack(hs, 1) if hs else a.new_zeros(a.shape)
    return out.to(a.dtype), h
