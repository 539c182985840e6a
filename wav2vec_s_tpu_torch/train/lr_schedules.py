"""LR schedules with fairseq semantics (port of
``wav2vec_s_tpu/train/lr_schedules.py``).

``polynomial_decay`` (pre-training: warmup 5000, 400k updates, lr 5e-4),
``inverse_sqrt`` (CAAT fine-tuning: warmup 4000, warmup-init 1e-7), cosine
and tri-stage.  Each factory returns a plain ``step -> lr`` function on
Python numbers; the optimizer evaluates it at its own update count.
"""

from __future__ import annotations

import math


def polynomial_decay(lr: float, warmup_updates: int, total_updates: int,
                     end_lr: float = 0.0, power: float = 1.0):
    def sched(step):
        if step < warmup_updates:
            return lr * min(step / max(warmup_updates, 1), 1.0)
        frac = min(max((total_updates - step)
                       / max(total_updates - warmup_updates, 1), 0.0), 1.0)
        return (lr - end_lr) * frac ** power + end_lr
    return sched


def inverse_sqrt(lr: float, warmup_updates: int,
                 warmup_init_lr: float = 1e-7):
    def sched(step):
        if step < warmup_updates:
            return warmup_init_lr + step * (lr - warmup_init_lr) / max(
                warmup_updates, 1)
        return lr * warmup_updates ** 0.5 * max(step, 1.0) ** -0.5
    return sched


def cosine(lr: float, warmup_updates: int, total_updates: int,
           min_lr: float = 0.0):
    def sched(step):
        if step < warmup_updates:
            return lr * step / max(warmup_updates, 1)
        t = min(max((step - warmup_updates)
                    / max(total_updates - warmup_updates, 1), 0.0), 1.0)
        return min_lr + 0.5 * (lr - min_lr) * (1 + math.cos(math.pi * t))
    return sched


def tri_stage(lr: float, warmup_updates: int, hold_updates: int,
              decay_updates: int, init_lr_scale: float = 0.01,
              final_lr_scale: float = 0.05):
    init_lr, final_lr = lr * init_lr_scale, lr * final_lr_scale

    def sched(step):
        if step < warmup_updates:
            return init_lr + (lr - init_lr) * min(
                step / max(warmup_updates, 1), 1.0)
        if step < warmup_updates + hold_updates:
            return lr
        t = min(max((step - warmup_updates - hold_updates)
                    / max(decay_updates, 1), 0.0), 1.0)
        decay = lr * math.exp(math.log(max(final_lr_scale, 1e-9)) * t)
        return max(decay, final_lr)
    return sched


SCHEDULES = {
    "polynomial_decay": polynomial_decay,
    "inverse_sqrt": inverse_sqrt,
    "cosine": cosine,
    "tri_stage": tri_stage,
}
