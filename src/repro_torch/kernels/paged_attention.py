"""Wrapper of the hand-written CUDA paged-attention decode kernel.

The kernel (csrc/paged_attention.cu) replaces the Pallas TPU kernel of
the JAX package; its source note says what bounds it and how it is laid
out.  This wrapper takes CUDA tensors only: it checks device, dtype,
shape and contiguity, allocates the output, launches on the current
stream and raises if the launch is refused.  CPU tensors are
kernels/ops.py's business (it routes them to kernels/ref.py).

`paged_attention.launches` counts wrapper calls that launched the
kernel (one per paged layer per decode step): the serving path's use of
the kernel is proven by reading it around a run.
`paged_attention.combine_launches` counts the calls that split their
rows' pages over several blocks and so also launched the combine.
`launch_plan` lays a launch out from shapes the host knows: the wrapper
never reads `lens` back, so a call makes no device-to-host copy.
`plan` picks how many of a kv head's query heads a block holds (all of
them unless they overflow the shared memory, as absorbed MLA's 128 do)
and how many pages a stage holds; `smem_bytes` is the Python twin of
the kernel's shared-memory layout, `blocks_per_sm` how many such blocks
an SM holds, and `n_splits` the split count.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90
SMEM_SM = 233_472   # bytes of shared memory of one SM on sm_90
SMEM_RESERVED = 1_024  # bytes the runtime keeps of an SM's for each block

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}

TILE_TOKENS = 32   # tokens staged a step (whole pages; fewer if smem is short)
WAVES = 2          # blocks the split rule aims for, in SM counts
STAGES = 2         # tiles in shared memory (the kernel's kStages)

_lib: Optional[ctypes.CDLL] = None
_sm_count = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_launch.argtypes = (
            [P] * 10 + [I] * 14 + [F, I, I, P])
        lib.paged_attention_launch.restype = I
        lib.paged_attention_smem.argtypes = [I] * 10
        lib.paged_attention_smem.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _sm_count[idx]


def blocks_per_sm(smem: int) -> int:
    """Blocks of `smem` bytes of shared memory that one SM holds at once,
    as far as its shared memory limits them."""
    return max(1, SMEM_SM // (smem + SMEM_RESERVED))


def n_splits(rows: int, Hkv: int, P: int, n_sm: int, n_group: int = 1,
             per_sm: int = WAVES) -> int:
    """Blocks a (row, kv head, head group)'s live pages are divided over:
    enough for about WAVES blocks per SM, or as many as share an SM
    (`per_sm`, from the block's shared memory) where that is fewer, at
    most one per page of the table.  Only shapes the host knows enter,
    never `lens`."""
    pairs = max(rows * Hkv * n_group, 1)
    return max(1, min(P, -(-min(WAVES, per_sm) * n_sm // pairs)))


def _align16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(gh: int, dk: int, dv: int, dr: int, page: int, P: int,
               ppt: int, kv_size: int, q_size: int,
               share_v: bool = False) -> int:
    """Shared memory one block takes (bytes): the twin of layout() in
    csrc/paged_attention.cu.  Its own state for gh query heads (page
    ids, q in f32 padded to 4 features, accumulators, a tile's
    probabilities, m, l, the rescale), then STAGES tiles of ppt pages
    (K rows, V rows unless share_v, k_extra rows, two scales)."""
    tt = ppt * page
    q_ld = (dk + dr + 3) & ~3
    own = (_align16(4 * P) + _align16(4 * gh * q_ld) + _align16(4 * gh * dv)
           + _align16(4 * gh * tt) + 3 * _align16(4 * gh))
    stage = (_align16(tt * dk * kv_size)
             + (0 if share_v else _align16(tt * dv * kv_size))
             + _align16(tt * dr * q_size) + 2 * _align16(4 * tt))
    return own + STAGES * stage


def plan(H: int, Hkv: int, dk: int, dv: int, dr: int, page: int, P: int,
         kv_size: int, q_size: int, share_v: bool = False):
    """-> (gh, ppt): the query heads a block holds, a divisor of g = H /
    Hkv, and the pages a stage holds, from TILE_TOKENS tokens halved
    down to one page.  At the most pages a stage whose layout fits
    SMEM_MAX, all g heads where they fit (one group: every GQA shape);
    otherwise the largest gh at which WAVES blocks share an SM (a block
    alone on an SM leaves its 4 warps to hide the latency of the shared
    memory: scripts/paged_group_sweep.py finds absorbed MLA's decode
    1.6-1.8x slower so); failing that, the largest that fits."""
    g = H // Hkv
    size = lambda gh, ppt: smem_bytes(  # noqa: E731
        gh, dk, dv, dr, page, P, ppt, kv_size, q_size, share_v)
    ppts = [max(1, TILE_TOKENS // page)]
    while ppts[-1] > 1:
        ppts.append(ppts[-1] // 2)
    fits = [(gh, ppt) for ppt in ppts
            for gh in (d for d in range(g, 0, -1) if g % d == 0)
            if size(gh, ppt) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"paged_attention needs {size(1, 1)} B of shared "
                         f"memory for one head, dk={dk + dr}, dv={dv}, "
                         f"page={page}; a block has {SMEM_MAX}")
    for gh, ppt in fits:
        if gh == g or blocks_per_sm(size(gh, ppt)) >= WAVES:
            return gh, ppt
    return fits[0]


def launch_plan(B: int, H: int, Hkv: int, dk: int, dv: int, dr: int,
                page: int, P: int, kv_size: int, q_size: int, share_v: bool,
                n_sm: int):
    """-> (gh, ppt, n_split) of a launch: `plan`'s head group and pages a
    stage, then `n_splits` over the (row, kv head, head group) triples
    with as many blocks an SM as that layout lets share one."""
    gh, ppt = plan(H, Hkv, dk, dv, dr, page, P, kv_size, q_size, share_v)
    per_sm = blocks_per_sm(smem_bytes(gh, dk, dv, dr, page, P, ppt,
                                      kv_size, q_size, share_v))
    return gh, ppt, n_splits(B, Hkv, P, n_sm, H // Hkv // gh, per_sm)


def _check(name: str, x: torch.Tensor, device, shape, dtypes) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, want "
                         f"{tuple(shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} dtype {x.dtype} not in {list(dtypes)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lens: torch.Tensor, window: int = 0,
                    scale: Optional[float] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    k_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, dk[+dr]) f32|bf16; k_pages (n_pages, page, Hkv, dk) and
    v_pages (n_pages, page, Hkv, dv) f32|bf16|int8|fp8-e4m3; table
    (B, P) int32, entries >= n_pages unallocated; lens (B,) int32;
    k_scale/v_scale (n_pages, page, Hkv) f32 or None; k_extra
    (n_pages, page, Hkv, dr) in q's dtype or None.  -> (B, H, dv) in
    q's dtype.  Same contract as kernels/ref.paged_attention."""
    if not q.is_cuda:
        raise ValueError(f"the paged_attention kernel takes CUDA tensors, "
                         f"got q on {q.device}")
    dev = q.device
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError("want q (B, H, d) and pages (n_pages, page, Hkv, d)")
    B, H, dkq = q.shape
    n_pages, page, Hkv, dk = k_pages.shape
    dv = v_pages.shape[-1]
    if n_pages < 1 or Hkv < 1 or H % Hkv:
        raise ValueError(f"need n_pages >= 1 and Hkv | H, got n_pages="
                         f"{n_pages}, H={H}, Hkv={Hkv}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    _check("q", q, dev, (B, H, dkq), _Q_CODES)
    _check("k_pages", k_pages, dev, (n_pages, page, Hkv, dk), _KV_CODES)
    _check("v_pages", v_pages, dev, (n_pages, page, Hkv, dv),
           (k_pages.dtype,))
    _check("table", table, dev, (B, table.shape[-1]), (torch.int32,))
    _check("lens", lens, dev, (B,), (torch.int32,))
    for nm, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s is not None:
            _check(nm, s, dev, (n_pages, page, Hkv), (torch.float32,))
    dr = 0
    if k_extra is not None:
        dr = k_extra.shape[-1]
        _check("k_extra", k_extra, dev, (n_pages, page, Hkv, dr),
               (q.dtype,))
    if dkq != dk + dr:
        raise ValueError(f"q has {dkq} features, pages give dk={dk} + "
                         f"dr={dr}")
    lib = _library()
    qc, kvc = _Q_CODES[q.dtype], _KV_CODES[k_pages.dtype]
    P = table.shape[1]
    # the value pages are the key pages (absorbed MLA's latent plane)
    share = (v_pages.data_ptr() == k_pages.data_ptr()
             and v_pages.shape == k_pages.shape)
    gh, ppt, split = launch_plan(B, H, Hkv, dk, dv, dr, page, P,
                                 k_pages.element_size(), q.element_size(),
                                 share, sm_count(dev))
    scale = float(scale) if scale is not None else dkq ** -0.5
    out = torch.empty((B, H, dv), dtype=q.dtype, device=dev)
    if B == 0:
        return out
    part = (torch.empty((B * H, split, dv + 2), dtype=torch.float32,
                        device=dev) if split > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_launch(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(table), _ptr(lens),
            _ptr(k_scale), _ptr(v_scale), _ptr(k_extra), _ptr(out),
            _ptr(part), B, H, Hkv, dk, dv, dr, n_pages, page, P,
            int(window), ppt, split, gh, int(share), scale, qc, kvc, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error "
                           f"{err}")
    paged_attention.launches += 1
    if split > 1:
        paged_attention.combine_launches += 1
    return out


paged_attention.launches = 0
paged_attention.combine_launches = 0
