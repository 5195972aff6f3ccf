"""Exponential moving average of the parameters (reference src/utils.py:87-228).

Counterpart of ``causal_gen_tpu/utils/ema.py``, with the same semantics:

- decay(n) = clamp(1 - (1 + epoch/inv_gamma)^-power, min_value, beta) with
  epoch = max(n - update_after_step - 1, 0), and decay = 0 while epoch <= 0,
  which makes the update a straight copy;
- n is the *post-increment* count: the 1-based number of EMA updates made,
  this one included.

The decay is a host scalar computed in float32, as the JAX package computes
it; the update runs in place on the shadow tensors.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
from torch import Tensor


def ema_decay(update_count: int, beta: float = 0.999, update_after_step: int = 100,
              inv_gamma: float = 1.0, power: float = 1.0, min_value: float = 0.0) -> float:
    """Current EMA decay given the (1-based) number of EMA updates performed."""
    f32 = np.float32
    epoch = max(f32(update_count) - f32(update_after_step) - f32(1.0), f32(0.0))
    if epoch <= 0.0:
        return 0.0
    value = f32(1.0) - (f32(1.0) + epoch / f32(inv_gamma)) ** f32(-power)
    return float(min(max(value, f32(min_value)), f32(beta)))


@torch.no_grad()
def ema_update(ema_params: Iterable[Tensor], params: Iterable[Tensor], update_count: int,
               beta: float = 0.999, update_after_step: int = 100, inv_gamma: float = 1.0,
               power: float = 1.0, min_value: float = 0.0) -> None:
    """One EMA step, in place: ema <- decay * ema + (1 - decay) * params."""
    decay = ema_decay(update_count, beta, update_after_step, inv_gamma, power, min_value)
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=float(np.float32(1.0) - np.float32(decay)))
