"""Learning-rate schedules (paper §5.3: exp-decay for in-place, cosine for
NOS).  Port of ``repro.optim.schedules``: each returns a function of the
step (a host number) that gives a float."""
from __future__ import annotations

import math


def exponential_decay(base_lr: float, decay_rate: float = 0.97,
                      decay_steps: float = 1000.0):
    def fn(step):
        return base_lr * decay_rate ** (step / decay_steps)
    return fn


def cosine_schedule(base_lr: float, total_steps: int, min_lr: float = 0.0):
    def fn(step):
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * frac))
    return fn


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), min_lr)

    def fn(step):
        if step < warmup_steps:
            return base_lr * (step + 1) / max(warmup_steps, 1)
        return cos(step - warmup_steps)
    return fn
