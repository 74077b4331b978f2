"""Learning-rate schedule: linear warmup then cosine decay to an alpha
floor.  Counterpart of factored_neus_tpu/utils/schedule.py:
    iter < warmup:  factor = iter / warmup
    else:           p = (iter - warmup) / (end - warmup)
                    factor = (cos(pi p) + 1)/2 * (1 - alpha) + alpha
"""
from __future__ import annotations

import math


def lr_factor(step: int, warm_up_end: float, end_iter: int,
              alpha: float) -> float:
    step = float(step)
    if warm_up_end > 0 and step < warm_up_end:
        return step / max(warm_up_end, 1.0)
    progress = (step - warm_up_end) / max(end_iter - warm_up_end, 1.0)
    return (math.cos(math.pi * progress) + 1.0) * 0.5 * (1.0 - alpha) + alpha


def learning_rate(step: int, base_lr: float, warm_up_end: float,
                  end_iter: int, alpha: float) -> float:
    return base_lr * lr_factor(step, warm_up_end, end_iter, alpha)


def cos_anneal_ratio(step: int, anneal_end: float) -> float:
    """1.0 when anneal_end == 0, else min(1, step / anneal_end)."""
    if anneal_end == 0.0:
        return 1.0
    return min(1.0, float(step) / anneal_end)
