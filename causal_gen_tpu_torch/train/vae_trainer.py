"""HVAE training: the step, the epoch loop and the training run.

Counterpart of ``causal_gen_tpu/train/vae_trainer.py`` (reference
src/trainer.py:38-169): beta warmup counted in batches, gradient accumulation,
clip then skip on a large norm or a NaN, AdamW under warmup, EMA after the
update, and best-ELBO checkpoints.

The JAX package runs the whole step as one jitted program and skips without a
branch; here the step runs eagerly and reads one flag from the device per
step to decide whether to update. A skipped step advances neither ``step``,
the lr schedule, AdamW's moments nor ``ema_updates``, and adds one to
``skipped``. ``steps_per_call`` has no counterpart: every step is one call.
Posterior draws go through K1, and a DMoL head's loss through K3, on the card.
With ``cfg.remat`` the model recomputes its rematerialised blocks in each
microbatch's backward, which follows that microbatch's forward, so a
recompute replays that microbatch's own draws (``models/remat.py``).

Under a ``mesh`` (``parallel/mesh.py``) the step takes this rank's rows
(``shard_batch`` with ``microbatches=accu_steps``, so each microbatch is the
one-process step's; with ``space``, ``shard_batch_spatial``) and gives the
one-process step's result at the same global batch: the model takes the
mesh (the free-bits clamp of the global batch-mean KL, spatial halos), the
gradients are all-reduced after the microbatch loop and before the clip,
the norm counts each parameter once and the metrics, and so the skip, are
the global batch's. Injected draws are the rank's rows (each sharded
block's whole map, ``models/hvae.py``); drawn from a generator, each
``data`` rank seeds its own (``Mesh.generator``), and K1's Philox seeds come
from it: another stream than one process draws (``cond_prior``'s dropout
option is then one a shard, not one a batch), which is not a fault.

Batches come from ``data/loader.py`` as numpy arrays, x uint8 NHWC (NDHWC for
volumes); they cross to the device as uint8 NCHW (NCDHW) and are scaled to
[-1, 1] there. The train step runs the model with ``train=True``
(conditioning dropout under ``cond_prior``), the evaluation with ``False``, as
causal_gen_tpu/train/vae_trainer.py:93,182 do.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from causal_gen_tpu_torch.config import Config
from causal_gen_tpu_torch.parallel.tensor import sharded_parameters
from causal_gen_tpu_torch.train.checkpoint import CheckpointWriter, state_payload
from causal_gen_tpu_torch.train.state import TrainState, clip_by_global_norm, init_train_state
from causal_gen_tpu_torch.utils.ema import ema_update
from causal_gen_tpu_torch.utils.schedules import linear_warmup

log = logging.getLogger(__name__)

Noise = Optional[Sequence[Iterable[Tensor]]]  # one iterable of draws per microbatch


def preprocess_x(x: Tensor) -> Tensor:
    """uint8 [0, 255] -> float32 [-1, 1] (reference trainer.py:17)."""
    return (x.to(torch.float32) - 127.5) / 127.5


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, Tensor]:
    """A loader batch on ``device``: x uint8 N(D)HWC -> uint8 NC(D)HW, pa float32."""
    x = torch.from_numpy(np.ascontiguousarray(batch["x"])).to(device)
    return {"x": x.permute(0, x.dim() - 1, *range(1, x.dim() - 1)).contiguous(),
            "pa": torch.from_numpy(np.ascontiguousarray(batch["pa"], np.float32)).to(device)}


def train_step(cfg: Config, state: TrainState, batch: Dict[str, Tensor], noise: Noise = None,
               generator: Optional[torch.Generator] = None, mesh=None) -> Dict[str, Tensor]:
    """One optimizer step over ``cfg.accu_steps`` microbatches of ``batch``
    (x uint8 NC(D)HW, pa), in place on ``state``. ``noise`` gives each
    microbatch's draws (the parity mode: the dropout option under
    ``cond_prior`` with ``cond_drop_from``, then the posterior normals); else
    they come from ``generator``. ``mesh``: this rank's part of a
    parallel step (module docstring). Returns the metrics: device scalars,
    and ``skipped`` as a float."""
    model = state.model
    accu = cfg.accu_steps
    micro = batch["x"].shape[0] // accu
    # 1-based batch counter for beta warmup (reference trainer.py:55-59 counts
    # batches, not optimizer steps)
    first_iter = state.step * accu + 1
    state.optimizer.zero_grad(set_to_none=True)
    sums = {k: torch.zeros((), device=batch["x"].device) for k in ("elbo", "nll", "kl")}
    for i in range(accu):
        sl = slice(i * micro, (i + 1) * micro)
        beta = (cfg.beta * linear_warmup(first_iter + i, cfg.beta_warmup_steps)
                if cfg.beta_warmup_steps > 0 else cfg.beta)
        out = model(preprocess_x(batch["x"][sl]), batch["pa"][sl], beta=beta,
                    noise=None if noise is None else iter(noise[i]), generator=generator,
                    train=True, mesh=mesh)
        (out["elbo"] / accu).backward()
        for k in sums:
            sums[k] = sums[k] + out[k].detach() / accu
    params = list(model.parameters())
    for p in params:  # a parameter no loss reached gets a zero gradient, as in JAX
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = None
    if mesh is not None:
        sharded = sharded_parameters(model)
        sums = mesh.reduce_metrics(sums)
        mesh.reduce_gradients(params, sharded)
        norm = mesh.grad_norm(params, sharded)
    grad_norm = clip_by_global_norm([p.grad for p in params], cfg.grad_clip, norm)
    nan_found = torch.isnan(sums["nll"]) | torch.isnan(sums["kl"]) | torch.isnan(grad_norm)
    ok = bool(((grad_norm < cfg.grad_skip) & ~nan_found).item())
    if ok:
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        state.ema_updates += 1
        ema_update(state.ema.parameters(), params, state.ema_updates, beta=cfg.ema_rate)
    else:
        state.skipped += 1
    state.optimizer.zero_grad(set_to_none=True)
    return dict(sums, grad_norm=grad_norm, skipped=0.0 if ok else 1.0)


@torch.no_grad()
def eval_step(cfg: Config, ema: nn.Module, batch: Dict[str, Tensor], noise: Noise = None,
              generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
    """ELBO terms of the EMA parameters on ``batch``."""
    out = ema(preprocess_x(batch["x"]), batch["pa"], beta=cfg.beta,
              noise=None if noise is None else iter(noise[0]), generator=generator,
              train=False)
    return {k: out[k] for k in ("elbo", "nll", "kl")}


def run_epoch(cfg: Config, state: TrainState, loader: Iterable[Dict[str, np.ndarray]],
              generator: torch.Generator, training: bool) -> Dict[str, float]:
    """One pass over ``loader``: train steps or EMA evaluation. Metrics are
    read from the device once, at the end, and weighed by batch size; skipped
    updates count for nothing (trainer.py:78-87)."""
    device = next(state.model.parameters()).device
    skipped_before = state.skipped
    ms: List[Dict[str, Tensor]] = []
    sizes: List[int] = []
    for batch in loader:
        sizes.append(batch["x"].shape[0])
        b = to_device(batch, device)
        if training:
            ms.append(train_step(cfg, state, b, generator=generator))
        else:
            ms.append(eval_step(cfg, state.ema, b, generator=generator))
    stats = {"elbo": 0.0, "nll": 0.0, "kl": 0.0}
    n = 0.0
    for m, bs in zip(ms, sizes):
        w = (1.0 - float(m["skipped"])) * bs if training else float(bs)
        for k in stats:
            stats[k] += float(m[k]) * w
        n += w
    out = {k: v / max(n, 1.0) for k, v in stats.items()}
    if training:
        out["updates_skipped"] = state.skipped - skipped_before
    return out


def train(cfg: Config, model: nn.Module, loaders: Dict[str, Any], save_dir: Optional[str] = None,
          epochs: Optional[int] = None,
          callback: Optional[Callable[[int, TrainState, Dict[str, float]], None]] = None,
          init_state: Optional[TrainState] = None) -> Tuple[TrainState, Dict[str, float]]:
    """The whole training run (reference trainer.py:24-169; the
    visualisations are ``cli/main.py``'s ``callback``). ``model`` is the
    initialised HVAE on its device; ``init_state`` resumes from a loaded
    checkpoint."""
    if init_state is not None:
        state = init_state
    else:
        log.info("total params: %s", f"{sum(p.numel() for p in model.parameters()):,}")
        state = init_train_state(cfg, model)
    train_gen = torch.Generator().manual_seed(cfg.seed)
    eval_gen = torch.Generator().manual_seed(cfg.seed + 1)

    writer = CheckpointWriter(save_dir, cfg.ckpt_max_to_keep) if save_dir else None

    best_loss = float("inf")
    history: Dict[str, float] = {}
    for epoch in range(1, (epochs or cfg.epochs) + 1):
        t0 = time.time()
        tr = run_epoch(cfg, state, loaders["train"], train_gen, training=True)
        log.info("epoch %d | train nelbo %.4f nll %.4f kl %.4f | %.1fs",
                 epoch, tr["elbo"], tr["nll"], tr["kl"], time.time() - t0)
        history = {f"train_{k}": v for k, v in tr.items()}
        if epoch % cfg.eval_freq == 0:
            ev = run_epoch(cfg, state, loaders["valid"], eval_gen, training=False)
            log.info("epoch %d | valid nelbo %.4f nll %.4f kl %.4f",
                     epoch, ev["elbo"], ev["nll"], ev["kl"])
            history.update({f"valid_{k}": v for k, v in ev.items()})
            if ev["elbo"] < best_loss and writer is not None:
                best_loss = ev["elbo"]
                writer.save(state_payload(state),
                            {"config": cfg.to_dict(),
                             "extra": {"epoch": epoch, "best_loss": best_loss}},
                            step=state.step, metric=float(ev["elbo"]))
        if callback is not None:
            callback(epoch, state, history)
    return state, history
