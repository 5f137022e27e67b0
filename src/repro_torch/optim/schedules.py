"""Learning-rate schedules (substrate completeness; the paper uses constant
step sizes, Theorems 13/17 admit per-round eta^k)."""

from __future__ import annotations

import math


def constant(lr: float):
    return lambda k: lr


def inverse_decay(lr0: float, decay: float = 0.05):
    """eta_k = lr0 / (1 + decay*k) — the classical O(1/k) schedule that makes
    DSGD+OCS converge exactly (kills the variance floor)."""
    return lambda k: lr0 / (1.0 + decay * k)


def cosine(lr0: float, total: int, warmup: int = 0, floor: float = 0.0):
    def fn(k):
        if k < warmup:
            return lr0 * (k + 1) / max(warmup, 1)
        t = min(1.0, (k - warmup) / max(total - warmup, 1))
        return floor + 0.5 * (lr0 - floor) * (1 + math.cos(math.pi * t))

    return fn
