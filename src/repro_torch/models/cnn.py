"""Network-in-Network (NiN) CNN — the paper's CIFAR-100 architecture,
all K ensemble members in one pass.

9 conv layers in three NiN blocks (5x5 conv followed by two 1x1 "mlpconv"
layers), max/avg pooling between blocks, global average pooling into the
class logits; ReLU activations, trained with momentum SGD + l2 as in the
paper's Section 5.1.

Params keep the JAX package's names and layouts, stacked over members:
`conv_{i}_w` (K, k, k, C_in, C_out) in HWIO, `bias_{i}` (K, C_out),
`conv_out_w` (K, 1, 1, C, n_classes), `bias_out` (K, n_classes).  Images
are NHWC, one batch per member: (K, B, H, W, 3).  Inside, the members
fold into channels (B, K*C, H, W) in channels-last memory, and every conv
is one grouped convolution (groups=K) over all members: each member's
channels see only its own images and its own weights.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.device import DeviceLike, resolve_device

# (kind, out_channels, kernel, stride) — kind: conv | maxpool | avgpool
NIN_SPEC = (
    ("conv", 192, 5, 1), ("conv", 160, 1, 1), ("conv", 96, 1, 1),
    ("maxpool", 0, 3, 2),
    ("conv", 192, 5, 1), ("conv", 192, 1, 1), ("conv", 192, 1, 1),
    ("avgpool", 0, 3, 2),
    ("conv", 192, 3, 1), ("conv", 192, 1, 1),
)


def nin_init(n_classes: int = 100, in_ch: int = 3, width_mult: float = 1.0,
             seed: int = 0, device: DeviceLike = None,
             members: int = 1) -> dict:
    """Member-stacked params, torch-seeded, with the names, shapes and
    init scales of the JAX package's nin_init (the numbers differ:
    torch's generator is not jax.random)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def normal(shape, std):
        return torch.randn((members, *shape), generator=gen,
                           device=dev) * std

    params = {}
    ch = in_ch
    for i, (kind, out, k, _s) in enumerate(NIN_SPEC):
        if kind != "conv":
            continue
        out = max(8, int(out * width_mult))
        params[f"conv_{i}_w"] = normal((k, k, ch, out),
                                       1.0 / (k * math.sqrt(ch)))
        params[f"bias_{i}"] = torch.zeros((members, out), device=dev)
        ch = out
    # final 1x1 conv onto class logits
    params["conv_out_w"] = normal((1, 1, ch, n_classes), 1.0 / math.sqrt(ch))
    params["bias_out"] = torch.zeros((members, n_classes), device=dev)
    return params


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stride-1 "SAME" conv of all members at once: x (B, K*C_in, H, W),
    w (K, k, k, C_in, C_out) HWIO -> (B, K*C_out, H, W)."""
    K, k, _, cin, cout = w.shape
    wt = w.permute(0, 4, 3, 1, 2).reshape(K * cout, cin, k, k)
    return F.conv2d(x, wt, b.reshape(-1), padding=k // 2, groups=K)


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pool(x: torch.Tensor, k: int, s: int, kind: str) -> torch.Tensor:
    """reduce_window with "SAME" padding, as the JAX package pools: at
    k=3, s=2 that pads 0 before and 1 after (F.max_pool2d's symmetric
    padding would shift every window).  Max pads with -inf; the average
    pads with 0 and always divides by k*k, padded cells included."""
    ph = _same_pad(x.shape[-2], k, s)
    pw = _same_pad(x.shape[-1], k, s)
    pad = (pw[0], pw[1], ph[0], ph[1])
    if kind == "maxpool":
        return F.max_pool2d(F.pad(x, pad, value=-math.inf), k, s)
    return F.avg_pool2d(F.pad(x, pad, value=0.0), k, s)


def nin_apply(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images (K, B, H, W, 3), member k's batch at [k] -> logits
    (K, B, n_classes) of member k on its own batch."""
    K, B, H, W, C = images.shape
    x = images.permute(1, 2, 3, 0, 4).reshape(B, H, W, K * C)
    x = x.permute(0, 3, 1, 2)  # channels-last view, no copy
    for i, (kind, _out, k, s) in enumerate(NIN_SPEC):
        if kind == "conv":
            x = torch.relu(_conv(x, params[f"conv_{i}_w"],
                                 params[f"bias_{i}"]))
        else:
            x = _pool(x, k, s, kind)
    x = _conv(x, params["conv_out_w"], params["bias_out"])
    logits = x.mean(dim=(2, 3))  # global average pool, (B, K*n_classes)
    return logits.reshape(B, K, -1).transpose(0, 1)


def l2_reg(params: dict) -> torch.Tensor:
    """(K,) sum of squared conv weights of each member."""
    return sum(v.square().flatten(1).sum(1) for k, v in params.items()
               if k.endswith("_w"))


def nin_loss(params: dict, batch: dict, l2: float = 1e-4
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ((K,) loss of each member on its own batch, logits (K, B, C)).
    batch: {images (K, B, H, W, C), labels (K, B) int}."""
    logits = nin_apply(params, batch["images"])
    lg = logits.float()
    gold = lg.gather(-1, batch["labels"].long()[..., None])[..., 0]
    nll = (torch.logsumexp(lg, -1) - gold).mean(-1)
    return nll + l2 * l2_reg(params), logits
