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
The split count comes from `n_splits`, on shapes the host knows: the
wrapper never reads `lens` back, so a call makes no device-to-host copy.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}

TILE_TOKENS = 32   # tokens staged a step (whole pages; fewer if smem is short)
WAVES = 2          # blocks the split rule aims for, in SM counts

_lib: Optional[ctypes.CDLL] = None
_sm_count = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_launch.argtypes = (
            [P] * 10 + [I] * 12 + [F, I, I, P])
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


def n_splits(rows: int, Hkv: int, P: int, n_sm: int) -> int:
    """Blocks a (row, kv head) pair's live pages are divided over: enough
    for about WAVES blocks per SM, at most one per page of the table.
    Only shapes the host knows enter, never `lens`."""
    pairs = max(rows * Hkv, 1)
    return max(1, min(P, -(-WAVES * n_sm // pairs)))


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
    ppt = max(1, TILE_TOKENS // page)
    P = table.shape[1]
    smem = lambda n: lib.paged_attention_smem(  # noqa: E731
        H, Hkv, dk, dv, dr, page, P, n, qc, kvc)
    while ppt > 1 and smem(ppt) > SMEM_MAX:
        ppt //= 2
    if smem(ppt) > SMEM_MAX:
        raise ValueError(f"paged_attention needs {smem(ppt)} B of shared "
                         f"memory for g={H // Hkv}, dk={dkq}, dv={dv}, "
                         f"page={page}; a block has {SMEM_MAX}")
    scale = float(scale) if scale is not None else dkq ** -0.5
    out = torch.empty((B, H, dv), dtype=q.dtype, device=dev)
    if B == 0:
        return out
    split = n_splits(B, Hkv, P, sm_count(dev))
    part = (torch.empty((B * H, split, dv + 2), dtype=torch.float32,
                        device=dev) if split > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_launch(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(table), _ptr(lens),
            _ptr(k_scale), _ptr(v_scale), _ptr(k_extra), _ptr(out),
            _ptr(part), B, H, Hkv, dk, dv, dr, n_pages, page, P,
            int(window), ppt, split, scale, qc, kvc, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error "
                           f"{err}")
    paged_attention.launches += 1
    if split > 1:
        paged_attention.combine_launches += 1
    return out


paged_attention.launches = 0
paged_attention.combine_launches = 0
