"""LR schedules (functions of the step count).

Counterpart of ``repro/optim/schedule.py``.  The reference evaluates its
schedule in f32 on the device; here it is evaluated in numpy f32 on the
host, so the rate a step uses is the same f32 value, handed to the update
as a Python float.
"""

from __future__ import annotations

import numpy as np

__all__ = ["cosine_schedule"]


def cosine_schedule(
    peak_lr: float,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    min_ratio: float = 0.1,
):
    f32 = np.float32

    def lr(step) -> float:
        step = f32(int(step))
        if step < warmup_steps:
            return float(f32(peak_lr) * (step + f32(1)) / f32(max(warmup_steps, 1)))
        frac = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                       f32(0), f32(1))
        cos = f32(peak_lr) * (f32(min_ratio) + f32((1 - min_ratio) * 0.5)
                              * (f32(1) + np.cos(f32(np.pi) * frac)))
        return float(cos)

    return lr
