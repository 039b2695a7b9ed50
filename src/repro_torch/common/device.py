"""Device selection for the port's entry points.

Entry points (model init, the param bridge, the pool allocator, the
engine, the CLI) run on the card unless the caller asks for the CPU.
With no card present and no explicit device they raise: a run never
carries on on the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def entry_device(device: DeviceLike = None) -> torch.device:
    """resolve_device for an entry point: on the card, f32 products and
    convolutions stay f32 (no TF32), as the JAX package and the CPU
    compute them."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """ModelConfig.dtype string -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
