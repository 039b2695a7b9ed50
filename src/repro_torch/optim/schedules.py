"""Step -> learning-rate schedules.

Each is a function of the optimizer's (K,) int32 step tensor (one step
count per member) and returns the rate as a float32 tensor of the same
shape on the step's device, so an update never reads the device from
the host.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full(step.shape, lr, dtype=torch.float32,
                                   device=step.device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = (step.float() / max(total_steps, 1)).clamp(0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        wu = lr * step.float() / max(warmup, 1)
        return torch.where(step <= warmup, wu, cos(step - warmup))
    return fn
