"""The five hand-written kernels as torch.library custom ops.

Each op's CUDA implementation is the kernel's own wrapper
(kernels/<name>.py, which launches the CUDA kernel and counts the
launch); its fake implementation returns the outputs' shapes and dtypes
only, so a step traces through the kernels under FakeTensorMode with no
card; its flop formula (torch.utils.flop_counter) counts the work as the
JAX package's dry-run counts its program, dot products only
(launch/hlo_analysis.py there); and `register_sharding_rules` gives
each a DTensor sharding rule: the layouts on which it runs shard by
shard with no communication.

kernels/ops.py reaches an op only for a fake tensor, a DTensor or under a
dispatch mode (the dry-run's accounting, launch/cost_analysis.py); a
plain CUDA tensor calls the wrapper directly, which keeps the op's
dispatch off the host-bound decode path (chip_smoke.py phase 24 times
both).  A real CUDA tensor never reaches a fake implementation, and no
op falls back to the plain version: a CPU tensor never reaches one.

`executed_flops` is the flash kernel's own count: the products of the
key tiles its tile-skip predicate keeps (csrc/flash_attention.cu,
`tile_live`; ref.flash_tile_live is its twin), where the flop formula
counts every (query, key) pair as the reference's attend computes them.
The dry-run's roofline takes the former: a bound counts the work the
card does.

Nothing here builds or loads a kernel: that happens at the first launch.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import distill_loss as dl
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels import wkv6 as wk

LIB = "repro_torch"


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{LIB}::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: Optional[torch.Tensor],
                    k_pos: Optional[torch.Tensor], causal: bool, window: int,
                    scale: Optional[float]) -> torch.Tensor:
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale, q_pos=q_pos, k_pos=k_pos)


@flash_attention.register_fake
def _(q, k, v, q_pos, k_pos, causal, window, scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                 **kwargs) -> int:
    """Every (query, key) pair of every head, masked or not: 2 T S dh for
    the scores and 2 T S dv for the values, as the reference's `attend`
    computes them (its chunked path walks all of S)."""
    N, T, H, dh = q_shape
    S, dv = k_shape[1], v_shape[-1]
    return 2 * N * T * S * H * (dh + dv)


def flash_live_tiles(T: int, S: int, g: int, bq: int, bk: int, causal: bool,
                     window: int) -> int:
    """Tiles (bq group-major query rows of one kv head x bk keys) the flash
    kernel computes for one row with no positions (the top-left contract:
    query t at t, key s at s): ref.flash_tile_live's count, in closed
    form over blocks (numpy: no tensor op reaches a fake or dispatch mode
    the caller runs under)."""
    import numpy as np
    rows = g * T
    nq, nk = -(-rows // bq), -(-S // bk)
    t = np.arange(nq * bq) % T
    t[rows:] = t[0]
    t = t.reshape(nq, bq)
    tmin, tmax = t.min(1)[:, None], t.max(1)[:, None]
    lo = np.arange(nk)[None] * bk
    hi = np.minimum(lo + bk, S) - 1
    live = np.ones((nq, nk), dtype=bool)
    if causal:
        live &= lo <= tmax
    if window > 0:
        live &= hi > tmin - window
    return int(live.sum())


def _flash_executed(q, k, v, q_pos, k_pos, causal, window, scale) -> int:
    if q_pos is not None:  # per-row positions: the data decides
        return _flash_flops(tuple(q.shape), tuple(k.shape), tuple(v.shape))
    N, T, H, dh = q.shape
    S, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    bq, bk = fa.tiles(dh, q.dtype)
    live = flash_live_tiles(T, S, H // Hkv, bq, bk, causal, window)
    return 2 * N * Hkv * live * bq * bk * (dh + dv)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{LIB}::paged_attention", mutates_args=(),
                         device_types="cuda")
def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lens: torch.Tensor, window: int, scale: Optional[float],
                    k_scale: Optional[torch.Tensor],
                    v_scale: Optional[torch.Tensor],
                    k_extra: Optional[torch.Tensor]) -> torch.Tensor:
    return pa.paged_attention(q, k_pages, v_pages, table, lens,
                              window=window, scale=scale, k_scale=k_scale,
                              v_scale=v_scale, k_extra=k_extra)


@paged_attention.register_fake
def _(q, k_pages, v_pages, table, lens, window, scale, k_scale, v_scale,
      k_extra):
    return q.new_empty((*q.shape[:2], v_pages.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.paged_attention)
def _paged_flops(q_shape, k_shape, v_shape, table_shape, *args,
                 out_shape=None, **kwargs) -> int:
    """One query a slot over every position its page table can hold
    (the lengths are data: the formula counts the table's capacity),
    2 dk + 2 dv a (query head, position) pair."""
    B, H, dkq = q_shape
    L = table_shape[-1] * k_shape[1]
    return 2 * B * H * L * (dkq + v_shape[-1])


# ---------------------------------------------------------------------------
# fused distillation loss (Eqn 9): the forward and backward kernels
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{LIB}::distill_loss_fwd", mutates_args=(),
                         device_types="cuda")
def distill_loss_fwd(logits: torch.Tensor, labels: torch.Tensor,
                     pseudo: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return dl.distill_loss_fwd(logits, labels, pseudo)


@distill_loss_fwd.register_fake
def _(logits, labels, pseudo):
    N = logits.shape[0]
    return tuple(logits.new_empty((N,), dtype=torch.float32)
                 for _ in range(3))


@torch.library.custom_op(f"{LIB}::distill_loss_bwd", mutates_args=(),
                         device_types="cuda")
def distill_loss_bwd(logits: torch.Tensor, labels: torch.Tensor,
                     pseudo: torch.Tensor, lse: torch.Tensor,
                     g: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    return dl.distill_loss_bwd(logits, labels, pseudo, lse, g, lam)


@distill_loss_bwd.register_fake
def _(logits, labels, pseudo, lse, g, lam):
    return torch.empty_like(logits)


@register_flop_formula(torch.ops.repro_torch.distill_loss_fwd)
def _distill_fwd_flops(logits_shape, *args, out_shape=None, **kwargs) -> int:
    """Eqn 9's one contraction, <pseudo, z> a row: 2 N V."""
    N, V = logits_shape
    return 2 * N * V


@register_flop_formula(torch.ops.repro_torch.distill_loss_bwd)
def _distill_bwd_flops(*args, out_shape=None, **kwargs) -> int:
    """The gradient is elementwise: no contraction."""
    return 0


# ---------------------------------------------------------------------------
# the recurrences: wkv6 and the Mamba selective scan (state in place)
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{LIB}::wkv6", mutates_args=("state",),
                         device_types="cuda")
def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor,
         state: torch.Tensor) -> torch.Tensor:
    return wk.wkv6(r, k, v, log_w, u, state)


@wkv6.register_fake
def _(r, k, v, log_w, u, state):
    return torch.empty_like(r)


@register_flop_formula(torch.ops.repro_torch.wkv6)
def _wkv6_flops(r_shape, *args, out_shape=None, **kwargs) -> int:
    """A token of a head reads r against the (dh, dh) state and adds the
    k v outer product: 2 dh^2 + 2 dh^2."""
    N, T, H, dh = r_shape
    return 4 * N * T * H * dh * dh


@torch.library.custom_op(f"{LIB}::ssm_scan", mutates_args=("state",),
                         device_types="cuda")
def ssm_scan(a: torch.Tensor, b: torch.Tensor,
             state: torch.Tensor) -> torch.Tensor:
    return ss.ssm_scan(a, b, state)


@ssm_scan.register_fake
def _(a, b, state):
    return torch.empty_like(a)


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def _ssm_scan_flops(*args, out_shape=None, **kwargs) -> int:
    """h_t = a_t h_{t-1} + b_t is elementwise: no contraction (the
    reference's scan lowers to no dot either)."""
    return 0


# ops whose roofline work differs from their flop formula's count
EXECUTED_FLOPS = {torch.ops.repro_torch.flash_attention.default:
                  _flash_executed}


# ---------------------------------------------------------------------------
# DTensor sharding rules
# ---------------------------------------------------------------------------

_registered = False


def register_sharding_rules() -> None:
    """Register every op's layouts with DTensor (once; DTensor's import
    costs a second, so it waits for the dry-run to ask).  A rule lists
    (output placements, input placements) a mesh dim may take; DTensor
    redistributes inputs onto the cheapest one."""
    global _registered
    if _registered:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R = Replicate()

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _flash(q, k, v, q_pos, k_pos, causal, window, scale):
        def pos(p):
            return [None if x is None else p for x in (q_pos, k_pos)]
        scalars = [None] * 3
        return [([R], [R] * 3 + pos(R) + scalars),
                # rows: every row attends alone
                ([Shard(0)], [Shard(0)] * 3 + pos(Shard(0)) + scalars),
                # heads: a query head reads its own kv head's shard
                ([Shard(2)], [Shard(2)] * 3 + pos(R) + scalars)]

    @register_sharding(torch.ops.repro_torch.paged_attention.default)
    def _paged(q, k_pages, v_pages, table, lens, window, scale, k_scale,
               v_scale, k_extra):
        opt = (lambda t: None if t is None else R)
        tail = [None, None, opt(k_scale), opt(v_scale), opt(k_extra)]
        return [([R], [R, R, R, R, R] + tail),
                ([Shard(0)], [Shard(0), R, R, Shard(0), Shard(0)] + tail)]

    @register_sharding(torch.ops.repro_torch.distill_loss_fwd.default)
    def _dfwd(logits, labels, pseudo):
        return [([R] * 3, [R] * 3), ([Shard(0)] * 3, [Shard(0)] * 3)]

    @register_sharding(torch.ops.repro_torch.distill_loss_bwd.default)
    def _dbwd(logits, labels, pseudo, lse, g, lam):
        return [([R], [R] * 6),
                ([Shard(0)], [Shard(0)] * 4 + [R, R])]

    @register_sharding(torch.ops.repro_torch.wkv6.default)
    def _wkv(r, k, v, log_w, u, state):
        return [([R], [R] * 6),
                # rows, members whole (state's K dim) or rows of one
                # member (state's B dim)
                ([Shard(0)], [Shard(0)] * 4 + [Shard(0), Shard(0)]),
                ([Shard(0)], [Shard(0)] * 4 + [R, Shard(1)]),
                # heads
                ([Shard(2)], [Shard(2)] * 4 + [Shard(1), Shard(2)])]

    @register_sharding(torch.ops.repro_torch.ssm_scan.default)
    def _scan(a, b, state):
        return [([R], [R] * 3),
                ([Shard(0)], [Shard(0), Shard(0), Shard(0)]),
                ([Shard(0)], [Shard(0), Shard(0), Shard(1)]),
                # channels
                ([Shard(2)], [Shard(2), Shard(2), Shard(2)])]

    _registered = True
