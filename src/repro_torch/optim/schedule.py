"""LR schedules (pure functions of the step), in float32 as the reference."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, peak: float, warmup_steps: int, total_steps: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to `peak`, then a cosine to ``floor_frac * peak``.
    `step` is an int or an integer tensor (the result lies on its device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak * step / max(1.0, warmup_steps)
    prog = torch.clamp(
        (step - warmup_steps) / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
