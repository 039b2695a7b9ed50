"""Dispatch by the tensors' device: the CUDA kernel on the card, the
plain PyTorch version (kernels/ref.py) on the CPU.

There is no switch and no fallback: a CUDA tensor always goes to the
hand-written kernel, which launches or raises.  The attention and
recurrence kernels are forward-only: on the card they refuse an input
that requires grad while grad mode is on (their output would carry no
gradient), where the plain versions on the CPU would differentiate.
Training takes the models' plain routes (transformer.apply(remat=True)).

A CUDA tensor that is fake (FakeTensorMode), a DTensor, or met under a
dispatch mode (the dry-run's accounting) goes through the kernel's
torch.library custom op (kernels/library.py): its fake implementation,
flop formula and DTensor sharding rule are what the dry-run traces, and
on a real tensor its CUDA implementation is the same wrapper.  A plain
CUDA tensor calls the wrapper directly, without the op's dispatch.  A
fake tensor on any device takes the custom op too (the op's fake
implementation serves every device): the dry-run's trace of the card's
program on a CPU-only torch, whose fake CUDA tensors cannot dispatch.
A real CPU tensor always takes the plain version.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.common.sharding import is_dtensor
from repro_torch.kernels import distill_loss as dl
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels import wkv6 as wk


def _kernel(x: torch.Tensor) -> bool:
    """Does x go to the kernel (its wrapper or its custom op)?  A CUDA
    tensor, or a fake one (a DTensor's local shard included)."""
    if x.is_cuda:
        return True
    local = x._local_tensor if is_dtensor(x) else x
    return isinstance(local, FakeTensor)


def _via_op(x: torch.Tensor) -> bool:
    """Take the custom op (a fake tensor, a DTensor, a dispatch mode)?"""
    if isinstance(x, FakeTensor) or is_dtensor(x) \
            or _get_current_dispatch_mode() is not None:
        from repro_torch.kernels import library  # noqa: F401  (registers)
        return True
    return False


def _forward_only(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only and an input requires "
            f"grad; train through the plain route "
            f"(transformer.apply(remat=True))")


def paged_attention(q, k_pages, v_pages, table, lens, window: int = 0,
                    scale=None, k_scale=None, v_scale=None, k_extra=None):
    """Decode attention over a paged KV pool; see kernels/ref.py for the
    contract.  The kernel reads only each slot's live pages."""
    kw = dict(window=window, scale=scale, k_scale=k_scale, v_scale=v_scale,
              k_extra=k_extra)
    if _kernel(q):
        _forward_only("paged_attention", q, k_pages, v_pages, k_extra)
        if _via_op(q):
            return torch.ops.repro_torch.paged_attention(
                q, k_pages, v_pages, table, lens, window, scale, k_scale,
                v_scale, k_extra)
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
    if _kernel(q):
        _forward_only("flash_attention", q, k, v)
        if _via_op(q):
            return torch.ops.repro_torch.flash_attention(
                q, k, v, q_pos, k_pos, causal, window,
                None if scale is None else float(scale))
        return fa.flash_attention(q, k, v, **kw)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, **kw)
    raise ValueError(f"flash_attention: no implementation for {q.device}")


def fused_distill_loss(logits, labels, pseudo, lam):
    """Eqn 9, mean over rows: (1+lam)*lse - z[y] - lam*<pseudo, z>; see
    kernels/ref.distill_loss.  On the card one forward and one backward
    kernel launch cover all rows."""
    if _kernel(logits):
        if _via_op(logits):
            return dl.fused_distill_loss(
                logits, labels, pseudo, lam,
                kernels=(torch.ops.repro_torch.distill_loss_fwd,
                         torch.ops.repro_torch.distill_loss_bwd))
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
    if _kernel(r):
        _forward_only("wkv6", r, k, v, log_w, u, state)
        if _via_op(r):
            return torch.ops.repro_torch.wkv6(r, k, v, log_w, u, state)
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
    if _kernel(a):
        _forward_only("ssm_scan", a, b, state)
        if _via_op(a):
            return torch.ops.repro_torch.ssm_scan(a, b, state)
        return ss.ssm_scan(a, b, state)
    if a.device.type == "cpu":
        N, _, D, Ns = a.shape
        hs, h_t = ref.ssm_scan(a, b, state.reshape(N, D, Ns))
        state.copy_(h_t.view(state.shape))
        return hs
    raise ValueError(f"ssm_scan: no implementation for {a.device}")
