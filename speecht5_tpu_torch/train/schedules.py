"""Learning-rate schedules (port of ``speecht5_tpu/train/schedules.py``):
warmup + inverse-sqrt decay, tri-stage and polynomial decay, as functions of
the update count (fairseq --lr-scheduler semantics)."""

from __future__ import annotations

import math


def inverse_sqrt(peak_lr: float, warmup_steps: int):
    """fairseq inverse_sqrt: linear warmup then lr * sqrt(warmup/step)."""

    def fn(step):
        step = max(step, 1)
        if step < warmup_steps:
            return peak_lr * step / warmup_steps
        return peak_lr * math.sqrt(warmup_steps / step)

    return fn


def tri_stage(peak_lr: float, warmup_steps: int, hold_steps: int,
              decay_steps: int, init_scale: float = 0.01,
              final_scale: float = 0.05):
    """fairseq tri_stage: warmup -> hold -> exponential decay to final_scale."""
    decay_factor = -math.log(final_scale) / max(decay_steps, 1)

    def fn(step):
        s = float(step)
        if s < warmup_steps:
            return peak_lr * (init_scale + (1 - init_scale) * min(s / warmup_steps, 1.0))
        if s < warmup_steps + hold_steps:
            return peak_lr
        in_decay = min(max(s - warmup_steps - hold_steps, 0), decay_steps)
        return peak_lr * math.exp(-decay_factor * in_decay)

    return fn


def polynomial_decay(peak_lr: float, warmup_steps: int, total_steps: int,
                     end_lr: float = 0.0, power: float = 1.0):
    def fn(step):
        s = float(step)
        if s < warmup_steps:
            return peak_lr * s / max(warmup_steps, 1)
        frac = min(max((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return (peak_lr - end_lr) * (1 - frac) ** power + end_lr

    return fn
