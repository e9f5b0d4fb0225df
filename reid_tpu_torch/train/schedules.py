"""Learning-rate schedules as plain step -> lr functions.

Counterpart of `reid_tpu/train/schedules.py` (ref `reid/train_prepare.py`
WarmUpScheduler :50-81 and WarmUpCosineScheduler :84-117), and of the
staircase `optax.exponential_decay` of the video loop. The step is
the optimizer's update count, a host integer, and the arithmetic is f32
as in the JAX package's traced schedule, so the lr is computed on the
host without a device read.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_F = np.float32


def warmup_cosine_schedule(base_lr: float, total_epochs: int,
                           steps_per_epoch: int, warmup_epochs: int = 10,
                           hold_epochs: int = 30, eta_min: float = 7e-7
                           ) -> Schedule:
    """Linear warm-up with factor 0.01 (1 - alpha) + alpha (alpha =
    epoch / warmup), the base lr held to `hold_epochs`, then a cosine to
    `eta_min` at `total_epochs`; epochs are fractional steps."""
    denom = _F(max(total_epochs - hold_epochs, 1))

    def schedule(step: int) -> float:
        epoch = _F(step) / _F(steps_per_epoch)
        if epoch < warmup_epochs:
            alpha = np.clip(epoch / _F(warmup_epochs), _F(0), _F(1))
            return float(_F(base_lr) * (_F(0.01) * (_F(1) - alpha) + alpha))
        if epoch < hold_epochs:
            return float(_F(base_lr))
        t = np.clip((epoch - _F(hold_epochs)) / denom, _F(0), _F(1))
        return float(_F(eta_min) + _F(0.5) * (_F(base_lr) - _F(eta_min))
                     * (_F(1) + np.cos(_F(np.pi) * t)))

    return schedule


def warmup_linear_hold_schedule(base_lr: float, steps_per_epoch: int,
                                warmup_epochs: int = 10,
                                warmup_factor: float = 0.01) -> Schedule:
    """Linear warm-up from warmup_factor * base_lr (factor = wf (1 -
    alpha) + alpha), then constant."""

    def schedule(step: int) -> float:
        epoch = _F(step) / _F(steps_per_epoch)
        alpha = np.clip(epoch / _F(warmup_epochs), _F(0), _F(1))
        return float(_F(base_lr) * (_F(warmup_factor) * (_F(1) - alpha)
                                    + alpha))

    return schedule


def staircase_exponential_schedule(init_value: float, transition_steps: int,
                                   decay_rate: float) -> Schedule:
    """`optax.exponential_decay(init_value, transition_steps, decay_rate,
    staircase=True)`: init * rate ** floor(step / transition_steps), in
    f32 (the video loop's StepLR(300, 0.5), ref video_reid_train.py:116)."""

    def schedule(step: int) -> float:
        if step <= 0:
            return float(_F(init_value))
        p = np.floor(_F(step) / _F(transition_steps))
        return float(_F(init_value) * np.power(_F(decay_rate), p))

    return schedule
