"""Wrapper of the hand-written CUDA flash-attention kernel.

The kernel (csrc/flash_attention.cu) replaces the Pallas TPU kernel of
the JAX package's `flash_attention`; its source note says what bounds it
and how it is laid out.  This wrapper takes CUDA tensors only: it checks
device, dtype, shape, contiguity and alignment, allocates the output,
launches on the current stream and raises if the launch is refused.
CPU tensors are kernels/ops.py's business (it routes them to
kernels/ref.py).

`flash_attention.launches` counts wrapper calls that launched the kernel
(one per attention layer per prefill call): the prefill path's use of
the kernel is proven by reading it around a run.
`flash_attention.combine_launches` counts the calls whose key tiles were
split over several blocks (`n_splits`) and so also launched the combine.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import sm_count

HEAD_DIMS = (32, 64, 128, 256)
BQ = 64            # group-major query rows per block
_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = (
            [P] * 7 + [I] * 9 + [F, I, P])
        lib.flash_attention_launch.restype = I
        lib.flash_attention_key_tile.argtypes = [I, I]
        lib.flash_attention_key_tile.restype = I
        _lib = lib
    return _lib


def tiles(dh: int, dtype: torch.dtype) -> tuple:
    """(query rows, keys) of the kernel's tiles, as csrc/flash_attention.cu
    sets them (`flash_attention_key_tile`): 64 keys, 32 for bf16 at dh
    256 (the tensor-core path's register budget)."""
    return BQ, 32 if (dtype == torch.bfloat16 and dh >= 256) else 64


def n_splits(N: int, T: int, H: int, Hkv: int, S: int, bk: int,
             n_sm: int) -> int:
    """Blocks a query tile's key tiles are divided over: 1 when the
    (row, kv head, query tile) blocks already fill the SMs, else enough
    to fill them, at most one per key tile."""
    blocks = N * Hkv * -(-(H // Hkv) * T // BQ)
    if blocks == 0 or blocks >= n_sm:
        return 1
    return max(1, min(-(-S // bk), -(-n_sm // blocks)))


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    q_pos: Optional[torch.Tensor] = None,
                    k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (N, T, H, dh), k/v (N, S, Hkv, dh), all f32 or all bf16, dh in
    HEAD_DIMS, Hkv | H, rows 16-byte aligned; q_pos (N, T) and k_pos
    (N, S) int32, both or neither.  -> (N, T, H, dh) in q's dtype.  Same
    contract as kernels/ref.attention."""
    if not q.is_cuda:
        raise ValueError(f"the flash_attention kernel takes CUDA tensors, "
                         f"got q on {q.device}")
    dev = q.device
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("want q (N, T, H, dh) and k/v (N, S, Hkv, dh)")
    N, T, H, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"need Hkv | H, got H={H}, Hkv={Hkv}")
    if S < 1:
        raise ValueError("need at least one key")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if (q_pos is None) != (k_pos is None):
        raise ValueError("pass both q_pos and k_pos, or neither")
    _check("q", q, dev, (N, T, H, dh), _CODES)
    _check("k", k, dev, (N, S, Hkv, dh), (q.dtype,))
    _check("v", v, dev, (N, S, Hkv, dh), (q.dtype,))
    if q_pos is not None:
        _check("q_pos", q_pos, dev, (N, T), (torch.int32,))
        _check("k_pos", k_pos, dev, (N, S), (torch.int32,))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    scale = float(scale) if scale is not None else dh ** -0.5
    out = torch.empty_like(q)
    if N == 0 or T == 0:
        return out
    lib = _library()
    split = n_splits(N, T, H, Hkv, S, tiles(dh, q.dtype)[1], sm_count(dev))
    part = (torch.empty((N * T * H, split, dh + 2), dtype=torch.float32,
                        device=dev) if split > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if q_pos is None else q_pos.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            N, T, S, H, Hkv, dh, int(bool(causal)), int(window), split,
            scale, _CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    if split > 1:
        flash_attention.combine_launches += 1
    return out


flash_attention.launches = 0
flash_attention.combine_launches = 0
