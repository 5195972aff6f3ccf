"""Train state and optimizer (reference src/train_setup.py:42-53).

Counterpart of ``causal_gen_tpu/train/state.py``. The JAX package keeps every
mutable training quantity in one pytree that its jitted step donates; here
they are the objects PyTorch updates in place: the model (parameters), its
EMA shadow, AdamW and its warmup schedule, plus the three counters.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import torch
from torch import Tensor, nn

from causal_gen_tpu_torch.config import Config


@dataclass
class TrainState:
    model: nn.Module  # the trained parameters
    ema: nn.Module  # the EMA shadow: a copy of ``model`` that takes no gradient
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0  # optimizer updates performed
    ema_updates: int = 0  # EMA updates performed (reference EMA.step)
    skipped: int = 0  # updates skipped by grad_skip or NaN (trainer.py:78-85)


def make_optimizer(cfg: Config, params: Iterable[Tensor]
                   ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW(lr, betas, weight_decay) under LambdaLR linear warmup, as
    reference train_setup.py:42-53 and ``optax.adamw`` with the JAX package's
    schedule: the lr of update k (0-based) is lr * min(1, k / warmup), so
    lr(0) = 0. Both put eps outside the square root and decay the weights by
    lr * wd * p on the old p."""
    opt = torch.optim.AdamW(list(params), lr=cfg.lr, betas=tuple(cfg.betas),
                            weight_decay=cfg.wd, eps=1e-8)
    warmup = cfg.lr_warmup_steps

    def factor(k: int) -> float:
        return 1.0 if warmup <= 0 else min(1.0, k / warmup)

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def init_train_state(cfg: Config, model: nn.Module) -> TrainState:
    ema = copy.deepcopy(model).requires_grad_(False)
    opt, sched = make_optimizer(cfg, model.parameters())
    return TrainState(model=model, ema=ema, optimizer=opt, scheduler=sched)


def global_norm(tensors: List[Tensor]) -> Tensor:
    """sqrt of the sum of squares of every element of ``tensors``."""
    return torch.sqrt(torch.sum(torch.stack(torch._foreach_norm(tensors)) ** 2))


def clip_by_global_norm(tensors: List[Tensor], max_norm: float,
                        norm: Optional[Tensor] = None) -> Tensor:
    """In place, torch.nn.utils.clip_grad_norm_ semantics: scale by
    max_norm / (norm + 1e-6) when that is below 1 (reference trainer.py:67-69).
    ``norm`` is the tensors' global norm where the caller has it (a parallel
    step's, over every rank's shards), else computed here. Returns the norm
    before clipping."""
    if norm is None:
        norm = global_norm(tensors)
    torch._foreach_mul_(tensors, torch.clamp(max_norm / (norm + 1e-6), max=1.0))
    return norm
