"""Warmup schedule (reference src/utils.py:32-35): counterpart of
``causal_gen_tpu/utils/schedules.py::linear_warmup``. The port's step loop
runs on the host, so the schedule is a plain function of a Python int."""

from __future__ import annotations

import numpy as np


def linear_warmup(step: int, warmup_steps: int) -> float:
    """lr/beta multiplier: step/warmup until warmup, then 1. Evaluated in
    float32, as the JAX package evaluates it."""
    if warmup_steps <= 0:
        return 1.0
    if step > warmup_steps:
        return 1.0
    return float(np.float32(step) / np.float32(warmup_steps))
