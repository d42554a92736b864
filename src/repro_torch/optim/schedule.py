"""Learning-rate schedules (pure functions of the step scalar).

Port of ``src/repro/optim/schedule.py``: the same float32 arithmetic on a
step given as an int or a tensor (the optimizer's int32 step on its
device, so the train step reads nothing back to the host).
"""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup"]


def cosine_warmup(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to floor * peak_lr; a float32 0-d
    tensor on ``step``'s device (the CPU for an int)."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = torch.tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * progress))
    return torch.where(step < warmup, warm, cos)
