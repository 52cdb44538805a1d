"""Per-step learning-rate schedules: pure ``step -> lr`` functions.

Counterpart of ``xclip_tpu/train/schedule.py`` (reference
training/scheduler.py): linear warmup into cosine, constant, or constant
with a cooldown; and, for the supervised baseline, optax's
``piecewise_constant_schedule`` (``learner.py:96-97``). The train step
evaluates them at the 0-based optimizer step before each update, as optax
evaluates a schedule at its count.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np

Schedule = Callable[[int], float]


def _warmup(base_lr: float, warmup_length: int, step: int) -> float:
    return base_lr * (step + 1) / max(warmup_length, 1)


def cosine_lr(base_lr: float, warmup_length: int, steps: int) -> Schedule:
    def schedule(step: int) -> float:
        if step < warmup_length:
            return _warmup(base_lr, warmup_length, step)
        e = step - warmup_length
        es = max(steps - warmup_length, 1)
        return 0.5 * (1 + math.cos(math.pi * e / es)) * base_lr

    return schedule


def const_lr(base_lr: float, warmup_length: int, steps: int = 0) -> Schedule:
    def schedule(step: int) -> float:
        return _warmup(base_lr, warmup_length, step) if step < warmup_length else base_lr

    return schedule


def const_lr_cooldown(base_lr: float, warmup_length: int, steps: int, cooldown_steps: int,
                      cooldown_power: float = 1.0, cooldown_end_lr: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        if step < warmup_length:
            return _warmup(base_lr, warmup_length, step)
        start_cooldown = steps - cooldown_steps
        if step < start_cooldown:
            return base_lr
        e = step - start_cooldown
        es = max(steps - start_cooldown, 1)
        decay = (1 - e / es) ** cooldown_power
        return decay * (base_lr - cooldown_end_lr) + cooldown_end_lr

    return schedule


def piecewise_constant(base_lr: float, boundaries_and_scales: Mapping[int, float]) -> Schedule:
    """``optax.piecewise_constant_schedule``: each boundary's scale applies
    from the step equal to the boundary on (a per-step boundary, not
    torch's per-epoch ``MultiStepLR``), in fp32 as optax computes it."""
    bounds = sorted(boundaries_and_scales.items())

    def schedule(step: int) -> float:
        v = np.float32(base_lr)
        for boundary, scale in bounds:
            if step >= boundary:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


def get_scheduler(name: str, base_lr: float, warmup: int, total_steps: int, **kw) -> Schedule:
    if name == "cosine":
        return cosine_lr(base_lr, warmup, total_steps)
    if name == "const":
        return const_lr(base_lr, warmup, total_steps)
    if name == "const-cooldown":
        return const_lr_cooldown(base_lr, warmup, total_steps, **kw)
    raise ValueError(f"unknown scheduler {name!r}")
