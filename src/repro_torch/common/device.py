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


def torch_dtype(name: str) -> torch.dtype:
    """ModelConfig.dtype string -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
