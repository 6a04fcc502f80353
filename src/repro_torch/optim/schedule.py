"""LR schedules (port of ``repro.optim.schedule``)."""
from __future__ import annotations

import numpy as np


def cosine_schedule(peak_lr: float, warmup_steps: int = 2000,
                    total_steps: int = 100_000, min_ratio: float = 0.1):
    """-> ``lr_fn(step)``: linear warmup to ``peak_lr``, then a cosine decay
    to ``min_ratio * peak_lr`` at ``total_steps``, held after it.

    ``step`` is an int (the optimizer's step count, kept on the host); the
    value is the reference's fp32 arithmetic, op for op, in numpy float32
    (a ``np.float32``; numpy's cos may differ from XLA's in the last bit),
    so the schedule costs the device nothing."""
    f32 = np.float32

    def lr_fn(step: int) -> np.float32:
        step = f32(step)
        warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
        prog = np.clip((step - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(peak_lr) * (f32(min_ratio) + f32((1 - min_ratio) * 0.5)
                              * (f32(1) + np.cos(f32(np.pi) * prog)))
        return warm if step < f32(warmup_steps) else cos

    return lr_fn
