"""LR schedules (a copy of ``repro.optim.schedules``)."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Scale in (0, 1]: linear warmup then cosine decay. step+1 so the very
    first step already has a nonzero learning rate."""
    step = torch.as_tensor(step).to(torch.float32) + 1.0
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
