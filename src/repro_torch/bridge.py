"""Param bridge: numpy trees (the JAX package's stacked params, fetched
with jax.device_get) -> the port's tensors, name for name.

The tree structure is kept as is (dicts, the `segments` list, leading
member and `count` axes), so the same weights run through both packages.
bfloat16 leaves arrive as ml_dtypes arrays and cross as raw 16-bit views;
no JAX or ml_dtypes import is needed here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device


def _leaf(a, device: torch.device, dtype: Optional[torch.dtype]):
    a = np.array(a, copy=True)  # owned and writable: torch shares it
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None):
    """Convert a nested dict/list/tuple tree of numpy arrays to tensors on
    `device` (the card unless given), casting floating leaves to `dtype`
    when one is given."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _leaf(x, dev, dtype)

    return conv(tree)
