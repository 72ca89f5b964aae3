"""Warmup + multi-factor learning-rate schedule (PyTorch counterpart of
deepim_tpu/engine/lr_schedule.py): a constant warmup_lr for the first
warmup_step updates, then the base lr times `factor` at each step in
`steps`.  The schedule is a plain function of the count of applied
updates, evaluated in float32 as the JAX package does."""
from __future__ import annotations

import numpy as np


def warmup_multifactor_schedule(base_lr: float, steps: tuple[int, ...], factor: float = 0.1,
                                warmup: bool = False, warmup_lr: float = 0.0,
                                warmup_step: int = 0):
    steps_arr = np.asarray(steps or (2**31 - 1,), np.int64)

    def schedule(count: int) -> float:
        n_passed = int(np.sum(count >= steps_arr))
        lr = np.float32(base_lr) * np.float32(factor) ** np.float32(n_passed)
        if warmup and count < warmup_step:
            lr = np.float32(warmup_lr)
        return float(np.float32(lr))

    return schedule


def lr_steps_from_config(lr_step: str, epoch_size: int, begin_epoch: int = 0) -> tuple[int, ...]:
    """Parse the '4, 6' epoch list into global update steps."""
    epochs = [float(s) for s in lr_step.replace(" ", "").split(",") if s]
    return tuple(int(e * epoch_size) for e in epochs if e > begin_epoch)
