"""Learning-rate schedules — port of the JAX package's ``train/schedules_lr.py``.

The reference's ``CosineAnnealingWarmupRestarts`` as a plain function
step → lr (``torch.optim.lr_scheduler.LambdaLR`` takes ``lambda s:
schedule(s) / base_lr``): cosine cycles with linear warmup, cycle-length
multiplication and per-cycle peak decay, computed in float32 as the JAX
schedule is.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

_F32 = np.float32


def cosine_annealing_warmup_restarts(
    first_cycle_steps: int,
    cycle_mult: float = 1.0,
    max_lr: float = 1e-4,
    min_lr: float = 1e-6,
    warmup_steps: int = 0,
    gamma: float = 1.0,
    max_cycles: int = 64,
) -> Callable[[int], float]:
    """Schedule: step → lr.

    Each cycle c has length first_cycle_steps·cycle_mult^c, starts with a
    linear warmup to max_lr·gamma^c, then cosine-decays to min_lr."""
    starts, lengths = [], []
    s, length = 0, first_cycle_steps
    for _ in range(max_cycles):
        starts.append(s)
        lengths.append(length)
        s += length
        length = max(int(length * cycle_mult), 1)
    starts_a = np.asarray(starts, dtype=_F32)
    lengths_a = np.asarray(lengths, dtype=_F32)
    max_lr_f, min_lr_f, warmup_f = _F32(max_lr), _F32(min_lr), _F32(warmup_steps)

    def schedule(step: int) -> float:
        step = _F32(step)
        cycle = int(np.clip(np.sum(step >= starts_a) - 1, 0, max_cycles - 1))
        start, length = starts_a[cycle], lengths_a[cycle]
        pos = np.clip(step - start, _F32(0), length)
        peak = max_lr_f * _F32(_F32(gamma) ** _F32(cycle))
        warm = np.minimum(warmup_f, length - _F32(1))
        if pos < warm:
            return float(min_lr_f + (peak - min_lr_f) * pos / np.maximum(warm, _F32(1)))
        t = np.clip((pos - warm) / np.maximum(length - warm, _F32(1)), _F32(0), _F32(1))
        return float(min_lr_f + _F32(0.5) * (peak - min_lr_f) * (_F32(1) + np.cos(_F32(math.pi) * t)))

    return schedule
