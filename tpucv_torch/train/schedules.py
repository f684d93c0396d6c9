"""Learning-rate schedules as plain ``step -> lr`` functions (counterpart of
``tpucv/train/schedules.py``). Each is a pure function of the iteration
counter; ``train.state`` writes its value into the optimizer before each
update."""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def warmup_multistep(
    base_lr: float,
    warmup_iters: int,
    milestones_iters: Sequence[int],
    gamma: float = 0.1,
    warmup_kind: str = "linear",
) -> Schedule:
    """Linear (or exponential) warmup multiplied into a multistep decay:
    during warmup the lr is dampened by (step+1)/warmup_iters (or
    1 - exp(-(step+1)/tau)); after each milestone it is scaled by
    ``gamma``."""
    ms = sorted(milestones_iters)
    period = max(warmup_iters, 1)

    def schedule(step: int) -> float:
        if warmup_kind == "exponential":
            damp = 1.0 - math.exp(-(step + 1.0) / period)
        else:
            damp = min((step + 1.0) / period, 1.0)
        return base_lr * damp * gamma ** bisect.bisect_right(ms, step)

    return schedule


def untuned_linear_warmup_period(beta2: float = 0.999) -> int:
    """Adam-rule warmup length: period = 2 / (1 - beta2)."""
    return int(math.ceil(2.0 / (1.0 - beta2)))


def untuned_exponential_warmup_tau(beta2: float = 0.999) -> float:
    """Adam-rule exponential warmup constant: tau = 1 / (1 - beta2)."""
    return 1.0 / (1.0 - beta2)


def cosine_with_warmup(base_lr: float, warmup_iters: int, total_iters: int,
                       final_scale: float = 0.01) -> Schedule:
    """Linear warmup from 0 to ``base_lr`` over ``warmup_iters``, then a
    cosine decay to ``base_lr * final_scale`` at ``total_iters`` (optax's
    ``warmup_cosine_decay_schedule``, as tpucv builds it)."""
    warmup = max(warmup_iters, 1)
    decay = max(total_iters, warmup_iters + 1) - warmup

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * min(max(step, 0), warmup) / warmup
        t = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return base_lr * ((1.0 - final_scale) * cosine + final_scale)

    return schedule
