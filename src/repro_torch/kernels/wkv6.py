"""Wrapper of the hand-written CUDA wkv6 kernel (the RWKV6 recurrence).

The kernel (csrc/wkv6.cu) replaces the Pallas TPU kernel of the JAX
package's `wkv6`; its source note says what bounds it and how it is
laid out: chunks of tokens computed at once, the value columns split
across blocks, and a kernel of its own for the T = 1 decode step.  This
wrapper takes CUDA tensors only: it checks device, dtype, shape and
layout, allocates the output, launches on the current stream and raises
if the launch is refused.  The state is updated in
place through its (member, slot) strides, so a layer's view of the
serving cache pool needs no copy.  CPU tensors are kernels/ops.py's
business (it routes them to kernels/ref.py).

`wkv6.launches` counts launches (one a call): the rwkv path's use of the
kernel is proven by reading it around a run.  `plan()` describes the
last launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 128
CHUNK, SUB = 16, 8     # the kernel's chunk and sub-block (ref.wkv6_chunked)
PLAN_KEYS = ("path", "blocks", "threads", "chunk", "col_tile", "smem_bytes",
             "vec16")
PATHS = ("step", "chunked")

_lib: Optional[ctypes.CDLL] = None
_plan = (ctypes.c_int * len(PLAN_KEYS))()


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("wkv6")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.wkv6_launch.argtypes = ([P] * 8 + [I] * 5 + [L] * 4
                                    + [ctypes.POINTER(I), P])
        lib.wkv6_launch.restype = I
        _lib = lib
    return _lib


def plan() -> dict:
    """The last launch: path ("step" at T = 1, else "chunked"), blocks,
    threads a block, chunk (0 on the step path), value-column tile (64
    at dh 33-64 on the 16-byte path, 32 below it or on the 4-byte path,
    16 above dh 64; 0 on the step path), dynamic shared bytes, and whether it took 16-byte accesses."""
    out = dict(zip(PLAN_KEYS, _plan))
    out["path"] = PATHS[out["path"]]
    out["vec16"] = bool(out["vec16"])
    return out


def _check(name: str, x: torch.Tensor, device, shape) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, r on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, want "
                         f"{tuple(shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} dtype {x.dtype} is not torch.float32")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor,
         state: torch.Tensor) -> torch.Tensor:
    """r/k/v/log_w (N, T, H, dh) f32 contiguous, N = K * B, dh <= 128;
    u (K, H, dh) f32 contiguous; state (K, B, H, dh, dh) f32, [key,
    value], its last three axes contiguous and any strides on the first
    two.  Reads state as s0 and overwrites it with s_T.  -> y (N, T, H,
    dh).  Same contract as kernels/ref.wkv6 (which returns s_T)."""
    if not r.is_cuda:
        raise ValueError(f"the wkv6 kernel takes CUDA tensors, got r on "
                         f"{r.device}")
    dev = r.device
    if r.dim() != 4 or u.dim() != 3 or state.dim() != 5:
        raise ValueError("want r/k/v/log_w (N, T, H, dh), u (K, H, dh) and "
                         "state (K, B, H, dh, dh)")
    N, T, H, dh = r.shape
    K, B = state.shape[:2]
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} not in [1, {MAX_HEAD_DIM}]")
    if K * B != N:
        raise ValueError(f"state folds K={K} x B={B} rows, r has N={N}")
    for name, x in (("r", r), ("k", k), ("v", v), ("log_w", log_w)):
        _check(name, x, dev, (N, T, H, dh))
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check("u", u, dev, (K, H, dh))
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    _check("state", state, dev, (K, B, H, dh, dh))
    if state.stride()[2:] != (dh * dh, dh, 1):
        raise ValueError(f"state's (H, dh, dh) axes must be contiguous, "
                         f"strides are {state.stride()}")
    sk, sb = state.stride()[:2]
    if (B > 1 and sb < H * dh * dh) or (K > 1 and sk < B * max(sb, 1)):
        raise ValueError(f"state's rows overlap (strides {state.stride()}):"
                         f" the kernel writes every row")
    y = torch.empty_like(r)
    if N == 0:
        return y
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr(), state.data_ptr(), state.data_ptr(), y.data_ptr(),
            K, B, T, H, dh, sk, sb, sk, sb, _plan, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err}")
    wkv6.launches += 1
    return y


wkv6.launches = 0
