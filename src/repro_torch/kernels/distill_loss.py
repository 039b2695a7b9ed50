"""Wrappers of the hand-written CUDA fused distillation-loss kernels.

The kernels (csrc/distill_loss.cu) replace the Pallas TPU kernel pair of
the JAX package's `fused_distill_loss`; the source note says what bounds
them and how they are laid out.  The wrappers take CUDA tensors only:
they check device, dtype, shape and contiguity, allocate the outputs,
launch on the current stream and raise if a launch is refused.  CPU
tensors are kernels/ops.py's business (it routes them to kernels/ref.py).

`FusedDistillLoss` is the autograd Function: its forward launches the
forward kernel and forms the Eqn-9 mean in torch (as the JAX package
does outside its kernel); its backward launches the backward kernel from
the saved row logsumexp.  Each kernel counts its launches
(`distill_loss_fwd.launches`, `distill_loss_bwd.launches`): the training
path's use of the kernels is proven by reading them around a run.

A ctypes launch has no vmap rule: callers fold members into rows and
make one call over all of them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_V = 65535 * 1024  # the backward's grid.y limit at 256 threads x 4

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("distill_loss")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.distill_fwd_launch.argtypes = [P] * 6 + [L, I, I, I, P]
        lib.distill_fwd_launch.restype = I
        lib.distill_bwd_launch.argtypes = [P] * 7 + [L, I, I, I, P]
        lib.distill_bwd_launch.restype = I
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, device, shape, dtypes) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, logits on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, want "
                         f"{tuple(shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} dtype {x.dtype} not in {list(dtypes)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(logits: torch.Tensor, labels: torch.Tensor,
                pseudo: torch.Tensor) -> Tuple[int, int]:
    if not logits.is_cuda:
        raise ValueError(f"the distill_loss kernels take CUDA tensors, got "
                         f"logits on {logits.device}")
    if logits.dim() != 2:
        raise ValueError(f"want logits (N, V), got {tuple(logits.shape)}")
    N, V = logits.shape
    if N >= 2 ** 31 or not 0 < V <= MAX_V:
        raise ValueError(f"need N < 2**31 and 0 < V <= {MAX_V}, got "
                         f"N={N}, V={V}")
    dev = logits.device
    _check("logits", logits, dev, (N, V), _CODES)
    _check("labels", labels, dev, (N,), (torch.int32,))
    _check("pseudo", pseudo, dev, (N, V), _CODES)
    return N, V


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def distill_loss_fwd(logits: torch.Tensor, labels: torch.Tensor,
                     pseudo: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (N, V) f32|bf16, labels (N,) int32 (outside [0, V) hits no
    column), pseudo (N, V) f32|bf16 -> per-row (lse, gold, dot), f32.
    Same contract as kernels/ref.distill_loss_parts."""
    N, V = _check_rows(logits, labels, pseudo)
    dev = logits.device
    lse, gold, dot = torch.empty((3, N), dtype=torch.float32, device=dev)
    if N == 0:
        return lse, gold, dot
    with torch.cuda.device(dev):
        err = _library().distill_fwd_launch(
            logits.data_ptr(), pseudo.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), gold.data_ptr(), dot.data_ptr(), N, V,
            _CODES[logits.dtype], _CODES[pseudo.dtype], _stream(dev))
    if err != 0:
        raise RuntimeError(f"distill_loss forward launch failed: CUDA "
                           f"error {err}")
    distill_loss_fwd.launches += 1
    return lse, gold, dot


def distill_loss_bwd(logits: torch.Tensor, labels: torch.Tensor,
                     pseudo: torch.Tensor, lse: torch.Tensor,
                     g: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """dz = g/N * ((1+lam)*softmax(z) - onehot(y) - lam*pseudo) in the
    logits' dtype; lse (N,) f32 from the forward; g and lam 0-d f32
    tensors on the card (read there: no host sync)."""
    N, V = _check_rows(logits, labels, pseudo)
    dev = logits.device
    _check("lse", lse, dev, (N,), (torch.float32,))
    _check("g", g, dev, (), (torch.float32,))
    _check("lam", lam, dev, (), (torch.float32,))
    dz = torch.empty_like(logits)
    if N == 0:
        return dz
    with torch.cuda.device(dev):
        err = _library().distill_bwd_launch(
            logits.data_ptr(), pseudo.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), g.data_ptr(), lam.data_ptr(), dz.data_ptr(),
            N, V, _CODES[logits.dtype], _CODES[pseudo.dtype], _stream(dev))
    if err != 0:
        raise RuntimeError(f"distill_loss backward launch failed: CUDA "
                           f"error {err}")
    distill_loss_bwd.launches += 1
    return dz


distill_loss_fwd.launches = 0
distill_loss_bwd.launches = 0


class FusedDistillLoss(torch.autograd.Function):
    """(logits (N, V), labels (N,), pseudo (N, V), lam 0-d f32) -> the
    Eqn-9 mean; gradient for the logits only."""

    @staticmethod
    def forward(ctx, logits, labels, pseudo, lam):
        lse, gold, dot = distill_loss_fwd(logits, labels, pseudo)
        ctx.save_for_backward(logits, labels, pseudo, lam, lse)
        return ((1.0 + lam) * lse - gold - dot * lam).mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, pseudo, lam, lse = ctx.saved_tensors
        dz = distill_loss_bwd(logits, labels, pseudo, lse,
                              g.float().contiguous(), lam)
        return dz, None, None, None


def fused_distill_loss(logits: torch.Tensor, labels: torch.Tensor,
                       pseudo: torch.Tensor, lam) -> torch.Tensor:
    """Eqn 9 over (..., V) logits on the card, rows flattened into one
    launch each way.  `lam` is a float or a 0-d f32 tensor on the card;
    pass a tensor in a loop (a float is copied there on every call)."""
    V = logits.shape[-1]
    if not torch.is_tensor(lam):
        lam = torch.tensor(lam, dtype=torch.float32, device=logits.device)
    _check("lam", lam, logits.device, (), (torch.float32,))
    return FusedDistillLoss.apply(logits.reshape(-1, V), labels.reshape(-1),
                                  pseudo.reshape(-1, V), lam)
