"""LR schedules (pure functions of the step index), in float32 as the
JAX package computes them."""

from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """Linear warmup then cosine decay to min_ratio * base_lr.  The
    returned ``lr(step)`` takes an int or a tensor and gives a float32
    0-d tensor on the step's device."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr
