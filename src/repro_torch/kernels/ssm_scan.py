"""Wrapper of the hand-written CUDA ssm_scan kernel (Mamba's selective
scan, h_t = a_t * h_{t-1} + b_t).

The kernel (csrc/ssm_scan.cu) replaces the Pallas TPU kernel of the JAX
package's `ssm_scan`; its source note says what bounds it and how it is
laid out.  This wrapper takes CUDA tensors only: it checks device,
dtype, shape and layout, allocates the output, launches on the current
stream and raises if the launch is refused.  The state is updated in
place through its (member, slot) strides, so a Mamba layer's view of
the serving cache pool needs no copy.  CPU tensors are kernels/ops.py's
business (it routes them to kernels/ref.py).

`ssm_scan.launches` counts launches (one a call): the Mamba path's use
of the kernel is proven by reading it around a run.  `plan()` describes
the last launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

PLAN_KEYS = ("small_t", "blocks", "threads", "floats_a_thread", "ahead")

_lib: Optional[ctypes.CDLL] = None
_plan = (ctypes.c_int * len(PLAN_KEYS))()


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("ssm_scan")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssm_scan_launch.argtypes = ([P] * 5 + [I] * 5 + [L] * 4
                                        + [ctypes.POINTER(I), P])
        lib.ssm_scan_launch.restype = I
        _lib = lib
    return _lib


def plan() -> dict:
    """The last launch: whether it took the small-T variant (T below 8),
    blocks, threads a block, floats a thread holds (4: 16-byte accesses), and
    steps of a and b loaded ahead of use."""
    out = dict(zip(PLAN_KEYS, _plan))
    out["small_t"] = bool(out["small_t"])
    return out


def _check(name: str, x: torch.Tensor, device, shape) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, a on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, want "
                         f"{tuple(shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} dtype {x.dtype} is not torch.float32")


def ssm_scan(a: torch.Tensor, b: torch.Tensor,
             state: torch.Tensor) -> torch.Tensor:
    """a/b (N, T, D, Ns) f32 contiguous, N = K * B; state (K, B, D, Ns)
    f32, its last two axes contiguous and any strides on the first two.
    Reads state as h0 and overwrites it with h_T.  -> hs (N, T, D, Ns).
    Same contract as kernels/ref.ssm_scan (which returns h_T)."""
    if not a.is_cuda:
        raise ValueError(f"the ssm_scan kernel takes CUDA tensors, got a on "
                         f"{a.device}")
    dev = a.device
    if a.dim() != 4 or state.dim() != 4:
        raise ValueError("want a/b (N, T, D, Ns) and state (K, B, D, Ns)")
    N, T, D, Ns = a.shape
    K, B = state.shape[:2]
    if K * B != N:
        raise ValueError(f"state folds K={K} x B={B} rows, a has N={N}")
    for name, x in (("a", a), ("b", b)):
        _check(name, x, dev, (N, T, D, Ns))
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check("state", state, dev, (K, B, D, Ns))
    if state.stride()[2:] != (Ns, 1):
        raise ValueError(f"state's (D, Ns) axes must be contiguous, "
                         f"strides are {state.stride()}")
    sk, sb = state.stride()[:2]
    row = D * Ns
    if (B > 1 and sb < row) or (K > 1 and sk < (B - 1) * sb + row):
        raise ValueError(f"state's rows overlap (strides {state.stride()}):"
                         f" the kernel writes every row")
    hs = torch.empty_like(a)
    if N == 0 or T == 0 or row == 0:
        return hs
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssm_scan_launch(
            a.data_ptr(), b.data_ptr(), state.data_ptr(), state.data_ptr(),
            hs.data_ptr(), K, B, T, D, Ns, sk, sb, sk, sb, _plan, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {err}")
    ssm_scan.launches += 1
    return hs


ssm_scan.launches = 0
