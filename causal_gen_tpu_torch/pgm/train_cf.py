"""Counterfactual fine-tuning of the merged DSCM (stage 3), in PyTorch.

Counterpart of ``causal_gen_tpu/pgm/train_cf.py`` (reference
src/pgm/train_cf.py: cf_epoch 111-220, the two optimizers 444-457, the
metrics 63-108). An update (``cf_train_step``):

- the Lagrangian ``DSCM.forward`` loss under a dense random intervention,
  its gradients averaged over ``accu_steps`` microbatches, as are the five
  metrics (train_cf.py:180-209);
- the global norm of every gradient, the VAE's and λ's, clipped at
  ``grad_clip`` (train_cf.py:210);
- the update is made only if that norm is below ``grad_skip`` and neither
  the loss nor the norm is NaN. The flag is read on the host once a step
  (the JAX step selects without a branch); a skipped update leaves the
  model, λ, both optimizer states and the EMA as they were;
- AdamW on the VAE at the constant ``lr``, the VAE's betas, eps 1e-8 and
  decay ``wd`` (not ``train/state.py::make_optimizer``, whose warmup gives
  lr 0 at the first update); ascent AdamW on λ (``maximize=True``, the JAX
  package's ``optax.scale(-1)``) at ``lr_lagrange`` with no decay, then
  λ clamped at 0 (train_cf.py:221-223);
- the EMA of the VAE and λ at ``ema_rate``, counted over the updates made.

Under a ``mesh`` (``parallel/mesh.py``; data parallelism) the batch, the
intervention and the draws are this rank's rows (``shard_batch`` with
``microbatches=accu_steps``) and the update is the one-process update at the
same global batch: ``DSCM.forward(mesh=)`` puts the global batch-mean ELBO
into the Lagrangian, the gradients are all-reduced before the clip, the
norm counts each parameter once and the metrics, and so the skip, are the
global batch's.

``steps_per_call`` has no counterpart here: the JAX package scans that many
updates in one dispatch, numerically the same as one at a time, and so
does this module, one at a time. The host's interventions
(``random_intervention``, the evaluation's train-set resamples) draw from
numpy generators exactly as the JAX package does, so a seed gives the same
interventions in both. The model's draws take ``noise`` (one iterable a
microbatch: the DSCM's draws in order) or a ``torch.Generator``.

Checkpoints: ``torch.save`` of the VAE, λ, their EMA, both optimizers'
states and the counters, with the config at ``<path>.meta.json``
(``train/checkpoint.py::write_payload``); ``convert.cf_state_from_jax``
fills a state from a JAX CF checkpoint.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from causal_gen_tpu_torch.parallel.tensor import sharded_parameters
from causal_gen_tpu_torch.pgm.dscm import DSCM
from causal_gen_tpu_torch.pgm.train_pgm import PGMConfig, preprocess_pgm_batch
from causal_gen_tpu_torch.train.checkpoint import write_payload
from causal_gen_tpu_torch.train.state import clip_by_global_norm
from causal_gen_tpu_torch.utils.ema import ema_update
from causal_gen_tpu_torch.utils.metrics import attribute_metrics

TERMS = ("loss", "aux_loss", "elbo", "nll", "kl", "morph_loss")  # the forward's scalars


@dataclass(frozen=True)
class CFConfig:
    """Hparams of counterfactual training (reference train_cf.py:223-284);
    the field set and defaults of the JAX package's ``CFConfig``."""

    seed: int = 7
    epochs: int = 5000
    bs: int = 32
    lr: float = 1e-4
    lr_lagrange: float = 1e-2
    ema_rate: float = 0.999
    # scales only the logged aux_loss (train_cf.py:207,270): the Lagrangian
    # never sees it, as in the reference
    alpha: float = 1.0
    lmbda_init: float = 0.0
    damping: float = 100.0
    do_pa: Optional[str] = None
    eval_freq: int = 1
    cf_particles: int = 1
    accu_steps: int = 1  # microbatches an update
    steps_per_call: int = 1  # accepted; updates run one at a time (module docstring)
    cf_remat: bool = False  # recompute each HVAE pass in the backward
    # from the VAE checkpoint (train_cf.py:404-411)
    beta: float = 1.0
    grad_clip: float = 350.0
    grad_skip: float = 500.0
    wd: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.9)
    elbo_constraint: float = 0.0
    # the soft-morphometry penalty (ops/soft_morph.py) and its calibration
    thickness_weight: float = 0.0
    intensity_weight: float = 0.0
    thickness_calib: Tuple[float, float] = (1.0, 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CFConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})


@dataclass
class CFTrainState:
    dscm: DSCM  # trained: dscm.vae's parameters and dscm.lmbda
    ema: DSCM  # the same PGM and predictor with the EMA of the VAE and of lmbda
    optimizer: torch.optim.AdamW  # the VAE's
    lagrange_optimizer: torch.optim.AdamW  # lmbda's (ascent)
    step: int = 0  # updates made
    ema_updates: int = 0
    skipped: int = 0


def make_cf_optimizers(cfg: CFConfig, vae_params: Iterable[Tensor], lmbda: Tensor
                       ) -> Tuple[torch.optim.AdamW, torch.optim.AdamW]:
    """``optax.adamw(lr, b1, b2, weight_decay=wd)`` on the VAE and
    ``chain(scale(-1), adamw(lr_lagrange, b1, b2, weight_decay=0))`` on λ
    (causal_gen_tpu/pgm/train_cf.py:101-112)."""
    betas = tuple(cfg.betas)
    return (torch.optim.AdamW(list(vae_params), lr=cfg.lr, betas=betas, eps=1e-8,
                              weight_decay=cfg.wd),
            torch.optim.AdamW([lmbda], lr=cfg.lr_lagrange, betas=betas, eps=1e-8,
                              weight_decay=0.0, maximize=True))


def init_cf_state(cfg: CFConfig, dscm: DSCM) -> CFTrainState:
    """A state around ``dscm`` (its VAE holding the starting weights): λ set
    to ``cfg.lmbda_init`` (the config is authoritative, as in JAX), the EMA a
    copy of both, fresh optimizers."""
    with torch.no_grad():
        dscm.lmbda.fill_(cfg.lmbda_init)
    ema = copy.copy(dscm)
    ema.vae = copy.deepcopy(dscm.vae).requires_grad_(False)
    ema.lmbda = torch.nn.Parameter(dscm.lmbda.detach().clone(), requires_grad=False)
    opt, l_opt = make_cf_optimizers(cfg, dscm.vae.parameters(), dscm.lmbda)
    return CFTrainState(dscm=dscm, ema=ema, optimizer=opt, lagrange_optimizer=l_opt)


def _trained(d: DSCM) -> List[Tensor]:
    return list(d.vae.parameters()) + [d.lmbda]


def _rows(tree: Dict[str, Tensor], sl: slice) -> Dict[str, Tensor]:
    return {k: v[sl] for k, v in tree.items()}


def cf_train_step(cfg: CFConfig, state: CFTrainState, batch: Dict[str, Tensor],
                  do: Dict[str, Tensor], do_mask: Dict[str, Tensor],
                  noise: Optional[Sequence[Iterable[Tensor]]] = None,
                  generator: Optional[torch.Generator] = None, mesh=None) -> Dict[str, Tensor]:
    """One update (causal_gen_tpu/pgm/train_cf.py:166-262) in place on
    ``state``, on ``batch`` (PGM space, ``preprocess_pgm_batch``) under the
    dense intervention (``do``, ``do_mask``: ``dense_intervention``).
    ``noise[i]`` gives microbatch i's draws, else they come from
    ``generator``. ``mesh``: this rank's part of a parallel update (module
    docstring). Returns the metrics as device scalars, λ before the update,
    and ``skipped`` as a float."""
    dscm = state.dscm
    accu = max(int(cfg.accu_steps), 1)
    micro = batch["x"].shape[0] // accu
    params = _trained(dscm)
    for opt in (state.optimizer, state.lagrange_optimizer):
        opt.zero_grad(set_to_none=True)
    sums = {k: torch.zeros((), device=batch["x"].device) for k in TERMS}
    for i in range(accu):
        sl = slice(i * micro, (i + 1) * micro)
        out = dscm.forward(_rows(batch, sl), _rows(do, sl), cf_particles=cfg.cf_particles,
                           beta=cfg.beta, do_mask=_rows(do_mask, sl), generator=generator,
                           noise=None if noise is None else noise[i], mesh=mesh)
        (out["loss"] / accu).backward()
        for k in TERMS:
            sums[k] = sums[k] + out[k].detach() / accu
    for p in params:  # a parameter no loss reached takes a zero gradient, as in JAX
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = None
    if mesh is not None:
        sharded = sharded_parameters(dscm.vae)
        sums = mesh.reduce_metrics(sums)
        mesh.reduce_gradients(params, sharded)
        norm = mesh.grad_norm(params, sharded)
    grad_norm = clip_by_global_norm([p.grad for p in params], cfg.grad_clip, norm)
    nan_found = torch.isnan(sums["loss"]) | torch.isnan(grad_norm)
    lmbda = dscm.lmbda.detach()[0].clone()
    ok = bool(((grad_norm < cfg.grad_skip) & ~nan_found).item())
    if ok:
        state.optimizer.step()
        state.lagrange_optimizer.step()
        with torch.no_grad():
            dscm.lmbda.clamp_(min=0.0)  # lambda >= 0 (train_cf.py:176-177)
        state.step += 1
        state.ema_updates += 1
        ema_update(_trained(state.ema), params, state.ema_updates, beta=cfg.ema_rate)
    else:
        state.skipped += 1
    for opt in (state.optimizer, state.lagrange_optimizer):
        opt.zero_grad(set_to_none=True)
    return dict(sums, lmbda=lmbda, grad_norm=grad_norm, skipped=0.0 if ok else 1.0)


def make_cf_eval_step(cfg: CFConfig, dscm: DSCM) -> Callable:
    """The evaluation step of ``dscm`` (the state's EMA) under
    ``torch.inference_mode``: fn(batch, do, generator=None, noise=None) ->
    (the forward's scalars, the predictor's outputs on the counterfactuals,
    the counterfactuals) (causal_gen_tpu/pgm/train_cf.py:265-283)."""

    @torch.inference_mode()
    def eval_step(batch, do, generator=None, noise=None):
        out = dscm.forward(batch, do, cf_particles=cfg.cf_particles, beta=cfg.beta,
                           generator=generator, noise=noise)
        cfs = out["cfs"]
        preds = dscm.predictor.predict(cfs["x"], **{k: v for k, v in cfs.items() if k != "x"})
        return {k: out[k] for k in TERMS}, preds, cfs

    return eval_step


def random_intervention(rng: np.random.Generator, dag_vars: Tuple[str, ...],
                        batch: Dict[str, Tensor], do_pa: Optional[str] = None
                        ) -> Dict[str, Tensor]:
    """do(pa_k) with the batch's values of pa_k permuted (train_cf.py:145-149);
    k drawn from ``rng`` unless ``do_pa`` names it, as the JAX package draws."""
    do_k = do_pa if do_pa else dag_vars[rng.integers(0, len(dag_vars))]
    perm = rng.permutation(batch[do_k].shape[0])
    return {do_k: batch[do_k][torch.from_numpy(perm).to(batch[do_k].device)]}


def dense_intervention(dag_vars: Tuple[str, ...], batch: Dict[str, Tensor],
                       do: Dict[str, Tensor]) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """A sparse do-dict as (values, (B, 1) masks) over every DAG variable."""
    n = batch["x"].shape[0]
    dev = batch["x"].device
    values, mask = {}, {}
    for k in dag_vars:
        inside = k in do
        values[k] = do[k] if inside else torch.zeros_like(batch[k])
        mask[k] = torch.full((n, 1), 1.0 if inside else 0.0, device=dev)
    return values, mask


def cf_state_payload(state: CFTrainState) -> Dict[str, Any]:
    """The state as tensors and ints on the CPU, both optimizers included
    (reference train_cf.py:511-529)."""
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    return {"vae": cpu(state.dscm.vae.state_dict()), "lmbda": state.dscm.lmbda.detach().cpu(),
            "ema_vae": cpu(state.ema.vae.state_dict()),
            "ema_lmbda": state.ema.lmbda.detach().cpu(),
            "opt_state": state.optimizer.state_dict(),
            "lagrange_opt_state": state.lagrange_optimizer.state_dict(),
            "step": state.step, "ema_updates": state.ema_updates, "skipped": state.skipped}


def save_cf_checkpoint(path: str, cfg: CFConfig, state: CFTrainState,
                       extra: Optional[Dict[str, Any]] = None) -> None:
    write_payload(os.path.abspath(path), cf_state_payload(state),
                  {"config": cfg.to_dict(), "extra": extra or {}})


def load_cf_meta(path: str) -> Tuple[CFConfig, Dict[str, Any]]:
    """(config, extra) of a CF checkpoint's ``.meta.json``."""
    with open(os.path.abspath(path) + ".meta.json") as f:
        meta = json.load(f)
    return CFConfig.from_dict(meta["config"]), meta.get("extra", {})


def restore_cf_state(state: CFTrainState, payload: Dict[str, Any]) -> CFTrainState:
    """In place: ``state`` takes a ``cf_state_payload``'s parameters (strict
    loads), λ, EMA, optimizer states and counters."""
    state.dscm.vae.load_state_dict(payload["vae"], strict=True)
    state.ema.vae.load_state_dict(payload["ema_vae"], strict=True)
    with torch.no_grad():
        state.dscm.lmbda.copy_(payload["lmbda"])
        state.ema.lmbda.copy_(payload["ema_lmbda"])
    state.optimizer.load_state_dict(payload["opt_state"])
    state.lagrange_optimizer.load_state_dict(payload["lagrange_opt_state"])
    state.step = int(payload["step"])
    state.ema_updates = int(payload["ema_updates"])
    state.skipped = int(payload["skipped"])
    return state


def load_cf_checkpoint(path: str, dscm: DSCM) -> Tuple[CFConfig, CFTrainState, Dict[str, Any]]:
    """(config, state around ``dscm`` on its device, extra) of a
    ``save_cf_checkpoint`` file."""
    cfg, extra = load_cf_meta(path)
    payload = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return cfg, restore_cf_state(init_cf_state(cfg, dscm), payload), extra


# the JAX package's name for the per-dataset metrics (train_cf.py:63-108)
cf_get_metrics = attribute_metrics


def _np(t: Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def cf_eval_epoch(cfg: CFConfig, pgm_cfg: PGMConfig, state: CFTrainState, loaders: Dict,
                  device: "str | torch.device", do_pa: Optional[str] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """A valid sweep of the EMA: do(pa_k) with values resampled from the
    train set (mapped into the PGM's space as the batches are), k drawn per
    batch unless ``do_pa``; the predictions on the counterfactuals scored
    against the interventions (reference train_cf.py:145-153, 181-189).
    Returns (the forward's scalars weighed by batch size, ``aux_loss`` times
    ``alpha``; the metrics)."""
    dag_vars = tuple(state.ema.pgm.dag_variables)
    attrs = loaders["train"].ds.attrs
    train_attrs = {k: _np(preprocess_pgm_batch(pgm_cfg, {k: np.asarray(attrs[k])}, "cpu")[k])
                   for k in dag_vars}
    host_rng = np.random.default_rng(cfg.seed + 1)
    eval_step = make_cf_eval_step(cfg, state.ema)
    stats = {k: 0.0 for k in TERMS}
    preds: Dict[str, list] = {k: [] for k in dag_vars}
    targets: Dict[str, list] = {k: [] for k in dag_vars}
    n = 0
    for raw in loaders["valid"]:
        batch = preprocess_pgm_batch(pgm_cfg, raw, device)
        bs = batch["x"].shape[0]
        do_k = do_pa if do_pa else dag_vars[int(host_rng.integers(0, len(dag_vars)))]
        vals = train_attrs[do_k]
        v = vals[host_rng.permutation(len(vals))[:bs]]
        do = {do_k: torch.tensor(v if v.ndim > 1 else v[:, None], dtype=torch.float32,
                                 device=device)}
        m, p, cfs = eval_step(batch, do, generator=generator)
        n += bs
        for k in TERMS:
            stats[k] += float(m[k]) * (cfg.alpha if k == "aux_loss" else 1.0) * bs
        for k in dag_vars:
            preds[k].append(_np(p[k]))
            targets[k].append(_np(do[k] if k in do else cfs[k]))
    stats = {k: v / max(n, 1) for k, v in stats.items()}
    metrics = attribute_metrics(pgm_cfg.dataset, {k: np.concatenate(v) for k, v in preds.items()},
                             {k: np.concatenate(v) for k, v in targets.items()})
    return stats, metrics


def cf_train_epoch(cfg: CFConfig, pgm_cfg: PGMConfig, state: CFTrainState, loader,
                   device: "str | torch.device", host_rng: np.random.Generator,
                   generator: Optional[torch.Generator] = None) -> Dict[str, float]:
    """One pass over ``loader``: a random single-parent intervention a batch
    (``random_intervention`` from ``host_rng``), then an update. Metrics are
    read from the device once, at the end, weighed by batch size; skipped
    updates count for nothing; ``aux_loss`` times ``alpha``."""
    dag_vars = tuple(state.dscm.pgm.dag_variables)
    ms, sizes = [], []
    for raw in loader:
        batch = preprocess_pgm_batch(pgm_cfg, raw, device)
        do = random_intervention(host_rng, dag_vars, batch, cfg.do_pa)
        do_values, do_mask = dense_intervention(dag_vars, batch, do)
        sizes.append(batch["x"].shape[0])
        ms.append(cf_train_step(cfg, state, batch, do_values, do_mask, generator=generator))
    stats = {k: 0.0 for k in TERMS}
    n = 0
    for m, bs in zip(ms, sizes):
        if m["skipped"]:
            continue
        n += bs
        for k in stats:
            stats[k] += float(m[k]) * (cfg.alpha if k == "aux_loss" else 1.0) * bs
    return {k: v / max(n, 1) for k, v in stats.items()}
