"""LR schedules, the port of the JAX package's ``optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, floor_frac: float = 0.1) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``floor_frac * peak_lr`` at ``total_steps`` (held after).
    The arithmetic is the reference's, op for op in float32 (CPU
    scalars); the result comes back as a Python float."""
    step = torch.as_tensor(step, dtype=torch.float32)
    if step < warmup_steps:
        return float(peak_lr * step / max(warmup_steps, 1))
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    return float(peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                            * (1 + torch.cos(math.pi * prog))))
