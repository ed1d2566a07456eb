"""Learning-rate schedules (counterpart of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_with_warmup"]


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       floor: float = 0.1):
    """``lr(step)``: linear warmup to ``peak_lr`` over ``warmup_steps``,
    then a cosine down to ``floor * peak_lr`` at ``total_steps``. ``step``
    is an integer tensor (or int); the result is a float32 0-d tensor on
    its device, computed in float32 as the reference computes it."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
