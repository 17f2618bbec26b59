"""Learning-rate schedules, computed in float32 as the reference's ``jnp``
scalars are; each returns a 0-d float32 tensor on the CPU."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).detach().to("cpu", torch.float32)


def warmup_cosine(peak_lr: float = 3e-4, warmup_steps: int = 100,
                  total_steps: int = 10_000, min_ratio: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(1, warmup_steps)
        frac = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps), 0, 1)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(lr_value: float = 1e-3):
    def lr(step):
        return torch.tensor(lr_value, dtype=torch.float32)
    return lr
