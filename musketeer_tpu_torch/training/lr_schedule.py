"""The learning-rate schedule (port of ``musketeer_tpu/training/lr_schedule.py``).

Linear warmup 0 → lr over ``warmup_updates``, then polynomial decay to
``end_lr`` at ``total_updates``: optax's ``join_schedules`` of a
``linear_schedule`` and a ``polynomial_schedule``, with their formulas. The
first update uses lr(0), which is 0 while warming up, as in optax.
"""

from __future__ import annotations

from typing import Callable

from ..config import OptimConfig


def _polynomial(init: float, end: float, power: float, steps: int, count: int) -> float:
    count = min(max(count, 0), steps)
    return (init - end) * (1 - count / steps) ** power + end


def polynomial_decay_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """update count → learning rate."""
    warmup = max(1, cfg.warmup_updates)
    decay = max(1, cfg.total_updates - cfg.warmup_updates)

    def schedule(count: int) -> float:
        if count < cfg.warmup_updates:
            return _polynomial(0.0, cfg.lr, 1.0, warmup, count)
        return _polynomial(cfg.lr, cfg.end_lr, cfg.power, decay, count - cfg.warmup_updates)

    return schedule
