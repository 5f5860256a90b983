"""LR schedules: linear warmup + cosine decay.

Counterpart of ``repro.optim.schedules``.  The multiplier is a host scalar
computed in float32 as the reference computes it on the device, so the
train step adds no device work and no host sync for it.
"""
from __future__ import annotations

import numpy as np


def warmup_cosine(step, *, warmup_steps=2000, total_steps=100_000,
                  min_ratio=0.1) -> np.float32:
    f = np.float32
    step = f(step)
    warm = (step + f(1.0)) / f(max(warmup_steps, 1))
    prog = np.clip((step - f(warmup_steps))
                   / f(max(total_steps - warmup_steps, 1)), f(0.0), f(1.0))
    cos = f(min_ratio) + f(1 - min_ratio) * f(0.5) * (
        f(1.0) + np.cos(f(np.pi) * prog))
    return f(warm if step < warmup_steps else cos)
