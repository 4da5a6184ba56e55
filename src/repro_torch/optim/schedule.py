"""Learning-rate schedules, the port's counterpart of
``repro.optim.schedule``: pure functions of the step counter (a 0-d
integer tensor), returning a 0-d f32 tensor on the step's device. Nothing
is read back to the host, in the reference's order of operations."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step: torch.Tensor, *, peak_lr: float, warmup: int, total: int,
                       floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine down
    to ``floor * peak_lr`` at ``total``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float) -> torch.Tensor:
    step = torch.as_tensor(step)
    return torch.full(step.shape, peak_lr, dtype=torch.float32, device=step.device)
