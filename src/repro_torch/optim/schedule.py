"""Learning-rate schedules (``repro/optim/schedule.py``)."""

from __future__ import annotations

import math


def cosine_warmup(step: int, base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> float:
    """Linear warmup over ``warmup`` steps, then a cosine decay from
    ``base_lr`` to ``min_frac * base_lr`` at ``total``."""
    if step < warmup:
        return base_lr * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * prog)))
