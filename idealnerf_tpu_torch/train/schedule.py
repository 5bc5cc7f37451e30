"""Learning-rate schedule (counterpart of train/schedule.py):
lrate * 0.1^(step / (lrate_decay * 1500))."""

from __future__ import annotations

from typing import Callable


def exponential_lr(lrate: float, lrate_decay: int) -> Callable[[int], float]:
    """-> lr(step), the rate of the update made at ``step`` (counted from
    0, before that update), as optax.exponential_decay gives it."""
    steps = lrate_decay * 1500

    def lr(step: int) -> float:
        return lrate * 0.1 ** (step / steps)

    return lr
