"""Learning-rate schedules (cf. ``repro.optim.schedules``): ``step -> lr``,
computed in float32 as the JAX package does."""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    return lambda step: float(np.float32(lr))


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step: int) -> float:
        t = np.float32(min(step, total_steps)) / np.float32(total_steps)
        cos = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(np.pi) * t))
        return float(np.float32(lr) * (np.float32(final_frac)
                                       + np.float32(1 - final_frac) * cos))
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    decay = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step: int) -> float:
        if step < warmup:
            return float(np.float32(lr) * np.float32(step)
                         / np.float32(max(warmup, 1)))
        return decay(step - warmup)
    return fn
