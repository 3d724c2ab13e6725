"""Learning-rate schedules (functions of the () int32 step tensor), from the
reference's ``src/repro/optim/schedules.py``."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32, device=step.device)


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def sched(step):
        frac = torch.clamp(step.float() / max(1, total_steps), 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))

    return sched


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    def sched(step):
        s = step.float()
        warm = peak * s / max(1, warmup_steps)
        frac = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, cos)

    return sched
