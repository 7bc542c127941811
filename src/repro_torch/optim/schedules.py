"""Learning-rate schedules (``repro.optim.schedules``): callables
``step -> lr`` returning 0-d f32 tensors (on the step's device when the
step is a tensor)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=getattr(step, "device", None))


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_step(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return (lr * (final_frac + (1 - final_frac) * cos)).to(torch.float32)
    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        s = _step(step)
        warm = lr * (s + 1) / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm,
                           cos(s - warmup_steps)).to(torch.float32)
    return fn
