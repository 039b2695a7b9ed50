"""Dispatch by the tensors' device: the CUDA kernel on the card, the
plain PyTorch version (kernels/ref.py) on the CPU.

There is no switch and no fallback: a CUDA tensor always goes to the
hand-written kernel, which launches or raises.
"""
from __future__ import annotations

from repro_torch.kernels import distill_loss as dl
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels import wkv6 as wk


def paged_attention(q, k_pages, v_pages, table, lens, window: int = 0,
                    scale=None, k_scale=None, v_scale=None, k_extra=None):
    """Decode attention over a paged KV pool; see kernels/ref.py for the
    contract.  The kernel reads only each slot's live pages."""
    kw = dict(window=window, scale=scale, k_scale=k_scale, v_scale=v_scale,
              k_extra=k_extra)
    if q.is_cuda:
        return pa.paged_attention(q, k_pages, v_pages, table, lens, **kw)
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_pages, v_pages, table, lens, **kw)
    raise ValueError(f"paged_attention: no implementation for {q.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, q_pos=None, k_pos=None):
    """Masked GQA attention, q (N, T, H, dh) over k/v (N, S, Hkv, dh),
    top-left without positions or by per-row q_pos (N, T) / k_pos
    (N, S); see kernels/ref.attention.  On the card one launch covers
    every row and head."""
    kw = dict(causal=causal, window=window, scale=scale, q_pos=q_pos,
              k_pos=k_pos)
    if q.is_cuda:
        return fa.flash_attention(q, k, v, **kw)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, **kw)
    raise ValueError(f"flash_attention: no implementation for {q.device}")


def fused_distill_loss(logits, labels, pseudo, lam):
    """Eqn 9, mean over rows: (1+lam)*lse - z[y] - lam*<pseudo, z>; see
    kernels/ref.distill_loss.  On the card one forward and one backward
    kernel launch cover all rows."""
    if logits.is_cuda:
        return dl.fused_distill_loss(logits, labels, pseudo, lam)
    if logits.device.type == "cpu":
        return ref.distill_loss(logits, labels, pseudo, lam)
    raise ValueError(f"fused_distill_loss: no implementation for "
                     f"{logits.device}")


def wkv6(r, k, v, log_w, u, state):
    """RWKV6 wkv recurrence, r/k/v/log_w (N, T, H, dh) f32 with N = K*B
    rows folding K members, u (K, H, dh), state (K, B, H, dh, dh) read as
    s0 and overwritten with s_T in place; -> y (N, T, H, dh).  See
    kernels/ref.wkv6.  On the card one launch covers every row and
    head."""
    if r.is_cuda:
        return wk.wkv6(r, k, v, log_w, u, state)
    if r.device.type == "cpu":
        N, _, H, dh = r.shape
        y, s_t = ref.wkv6(r, k, v, log_w, u, state.reshape(N, H, dh, dh))
        state.copy_(s_t.view(state.shape))
        return y
    raise ValueError(f"wkv6: no implementation for {r.device}")


def ssm_scan(a, b, state):
    """Mamba selective scan h_t = a_t * h_{t-1} + b_t, a/b (N, T, D, Ns)
    f32 with N = K*B rows folding K members, state (K, B, D, Ns) f32
    read as h0 and overwritten with h_T in place; -> hs (N, T, D, Ns).
    See kernels/ref.ssm_scan.  On the card one launch covers every row
    and state element."""
    if a.is_cuda:
        return ss.ssm_scan(a, b, state)
    if a.device.type == "cpu":
        N, _, D, Ns = a.shape
        hs, h_t = ref.ssm_scan(a, b, state.reshape(N, D, Ns))
        state.copy_(h_t.view(state.shape))
        return hs
    raise ValueError(f"ssm_scan: no implementation for {a.device}")
