"""PGM and anticausal-predictor training (PyTorch).

Counterpart of ``causal_gen_tpu/pgm/train_pgm.py`` (reference
src/pgm/train_pgm.py: preprocess 25-47, ss_train_epoch 50-108, sup_epoch
111-171, eval_epoch 174-249, main 313-567). Pyro's Trace_ELBO reduces, for
each setup, to:

- ``sup_pgm``: the empty guide and a fully observed model, loss =
  -sum log p(obs) / bs (``svi_logprob``);
- ``sup_aux``: the predictors' likelihood, loss = -sum log q(site | x, ...)
  / bs (``anticausal_logprob``; ChestPGM's with ``train=True``, its trunk's
  dropout on);
- ``semi_sup``: on a labelled batch -log p(obs) + alpha N_l times the
  predictors' negative log-likelihood; on an unlabelled batch a Monte-Carlo
  ELBO over the guide's draws, pathwise for the continuous guide sites and
  through the score-function surrogate elbo + log q_disc * sg(elbo) for the
  categorical and binary ones (the per-site split Trace_ELBO makes).

Each update clips the global gradient norm at ``grad_clip``, then AdamW
(b1 0.9, b2 0.999, eps 1e-8, decay ``wd`` on every parameter, as
``optax.adamw``), then the EMA at ``ema_rate`` (utils/ema.py, counted from
the 1-based update). A parameter no loss reaches takes a zero gradient, so
AdamW still decays it, as optax does. The step runs eagerly; the JAX step
is one jitted program.

Both steps take a ``mesh`` (``parallel/mesh.py``; data parallelism): the
batch is then this rank's rows, the gradients are all-reduced before the
clip and the metrics are the global batch's. The supervised loss divides by
the local batch, a mean, so its gradients are averaged over ``data``; the
semi-supervised loss is a sum over both batches, so its gradients and its
metrics are summed over ``data``.

The semi-supervised step takes ``draws``, the guide's draws by site
(``guide_sample``'s ``noise``), else they come from a ``torch.Generator``.
Checkpoints are ``torch.save`` files with a ``.meta.json`` beside
(``train/checkpoint.py::write_payload``); ``load_pgm_checkpoint`` rebuilds
the module from them.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from causal_gen_tpu_torch.train.checkpoint import write_payload
from causal_gen_tpu_torch.train.state import clip_by_global_norm
from causal_gen_tpu_torch.utils.ema import ema_update
from causal_gen_tpu_torch.utils.metrics import attribute_metrics
from causal_gen_tpu_torch.utils.normalization import get_attr_max_min

log = logging.getLogger(__name__)

SETUPS = ("sup_pgm", "sup_aux", "semi_sup")
_DISCRETE = ("categorical", "binary")


@dataclass(frozen=True)
class PGMConfig:
    """Hparams of PGM training (reference train_pgm.py:313-383)."""

    dataset: str = "morphomnist"
    setup: str = "sup_pgm"  # sup_pgm | sup_aux | semi_sup
    seed: int = 7
    epochs: int = 1000
    bs: int = 32
    lr: float = 1e-4
    wd: float = 0.1
    input_res: int = 32
    input_channels: int = 1
    pad: int = 4
    hflip: float = 0.5
    sup_frac: float = 1.0
    eval_freq: int = 1
    widths: Tuple[int, ...] = (32, 32)
    parents_x: Tuple[str, ...] = ()
    alpha: float = 1e-3
    std_fixed: float = 0.0
    grad_clip: float = 200.0
    ema_rate: float = 0.999

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PGMConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})


@dataclass
class PGMTrainState:
    model: nn.Module  # the trained parameters
    ema: nn.Module  # the EMA shadow, a copy of ``model`` that takes no gradient
    optimizer: torch.optim.AdamW
    step: int = 0  # updates made


def make_pgm_optimizer(cfg: PGMConfig, params: Iterable[Tensor]) -> torch.optim.AdamW:
    """``optax.adamw(lr, b1=0.9, b2=0.999, weight_decay=wd)``
    (causal_gen_tpu/pgm/train_pgm.py:107)."""
    return torch.optim.AdamW(list(params), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.wd)


def init_pgm_state(cfg: PGMConfig, model: nn.Module) -> PGMTrainState:
    return PGMTrainState(model=model, ema=copy.deepcopy(model).requires_grad_(False),
                         optimizer=make_pgm_optimizer(cfg, model.parameters()))


def preprocess_pgm_batch(cfg: PGMConfig, batch: Dict[str, np.ndarray],
                         device: "str | torch.device") -> Dict[str, Tensor]:
    """A loader batch (``concat_pa=False``) on ``device``: x uint8 NHWC ->
    float32 NCHW in [-1, 1]; each parent (B, d) float32; UK Biobank's raw
    age and volumes -> [-1, 1] by the attributes' max and min (reference
    preprocess, train_pgm.py:25-47)."""
    out: Dict[str, Tensor] = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if k == "x":
            out[k] = (t.permute(0, 3, 1, 2).to(torch.float32) - 127.5) / 127.5
            continue
        t = t.to(torch.float32)
        if t.dim() < 2:
            t = t[:, None]
        if "ukbb" in cfg.dataset and k in ("age", "brain_volume", "ventricle_volume"):
            k_max, k_min = get_attr_max_min(k)
            t = 2 * (t - k_min) / (k_max - k_min) - 1
        out[k] = t
    return out


def _attrs_only(model: nn.Module, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {k: v for k, v in batch.items() if k in model.dag_variables}


def _wants_train_flag(model: nn.Module) -> bool:
    from causal_gen_tpu_torch.pgm.flow_pgm import ChestPGM

    return isinstance(model, ChestPGM)


def site_logprobs(cfg: PGMConfig, model: nn.Module, batch: Dict[str, Tensor],
                  train: bool) -> Dict[str, Tensor]:
    """The per-site log-probs a supervised setup maximises: log p(obs) for
    ``sup_pgm``, log q(site | x, ...) otherwise (ChestPGM's trunk in
    ``train`` mode when training)."""
    obs = _attrs_only(model, batch)
    if cfg.setup == "sup_pgm":
        return model.svi_logprob(obs)
    if train and _wants_train_flag(model):
        return model.anticausal_logprob(batch["x"], train=True, **obs)
    return model.anticausal_logprob(batch["x"], **obs)


def _update(cfg: PGMConfig, state: PGMTrainState, mesh=None, batch_sum: bool = False
            ) -> Tensor:
    """(Under ``mesh``, reduce the gradients,) clip, AdamW, EMA; returns the
    gradient norm before clipping."""
    params = list(state.model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = None
    if mesh is not None:
        mesh.reduce_gradients(params, batch_sum=batch_sum)
        norm = mesh.grad_norm(params)
    grad_norm = clip_by_global_norm([p.grad for p in params], cfg.grad_clip, norm)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    ema_update(state.ema.parameters(), params, state.step, beta=cfg.ema_rate)
    return grad_norm


def train_step(cfg: PGMConfig, state: PGMTrainState, batch: Dict[str, Tensor], mesh=None
               ) -> Dict[str, Tensor]:
    """One ``sup_pgm`` or ``sup_aux`` update (causal_gen_tpu/pgm/train_pgm.py:
    136-183), in place on ``state``. Returns the loss, the gradient norm and
    each site's mean log-prob, as device scalars."""
    lps = site_logprobs(cfg, state.model, batch, train=True)
    bs = next(iter(batch.values())).shape[0]
    loss = -sum(torch.sum(v) for v in lps.values()) / bs
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grad_norm = _update(cfg, state, mesh)
    metrics = {"loss": loss.detach(), **{k: torch.sum(v.detach()) / bs for k, v in lps.items()}}
    if mesh is not None:
        metrics = mesh.reduce_metrics(metrics)
    return {**metrics, "grad_norm": grad_norm}


def semi_sup_loss(cfg: PGMConfig, model: nn.Module, batch_l: Dict[str, Tensor],
                  batch_u: Dict[str, Tensor], n_labelled: int,
                  draws: Optional[Dict[str, Tensor]] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The semi-supervised objective (causal_gen_tpu/pgm/train_pgm.py:
    196-245): loss_l + loss_u + alpha N_l aux_loss, with the unlabelled
    batch's attributes drawn from the guide (``draws`` or ``generator``)."""
    obs_l = _attrs_only(model, batch_l)
    loss_l = -sum(torch.sum(v) for v in model.svi_logprob(obs_l).values())
    empty = {k: None for k in model.dag_variables}
    values, logq = model.guide_sample(batch_u["x"], empty, generator=generator, noise=draws)
    logp_u = sum(model.svi_logprob(values).values())
    kinds = model.dag_variables
    zero = torch.zeros((), device=batch_u["x"].device)
    logq_cont = sum((v for k, v in logq.items() if kinds.get(k) not in _DISCRETE), zero)
    logq_disc = sum((v for k, v in logq.items() if kinds.get(k) in _DISCRETE), zero)
    elbo_u = logp_u - (logq_cont + logq_disc)
    # the score-function surrogate of the discrete guide sites
    loss_u = -torch.sum(elbo_u + logq_disc * elbo_u.detach())
    aux_loss = -sum(torch.sum(v) for v in
                    model.anticausal_logprob(batch_l["x"], **obs_l).values())
    loss = loss_l + loss_u + cfg.alpha * n_labelled * aux_loss
    return loss, {"loss_l": loss_l.detach(), "loss_u": -torch.sum(elbo_u.detach()),
                  "aux_loss": aux_loss.detach()}


def semi_sup_step(cfg: PGMConfig, state: PGMTrainState, batch_l: Dict[str, Tensor],
                  batch_u: Dict[str, Tensor], n_labelled: int,
                  draws: Optional[Dict[str, Tensor]] = None,
                  generator: Optional[torch.Generator] = None, mesh=None) -> Dict[str, Tensor]:
    """One semi-supervised update (causal_gen_tpu/pgm/train_pgm.py:247-262),
    in place on ``state``. Under ``mesh`` both batches and ``draws`` are
    this rank's rows."""
    loss, parts = semi_sup_loss(cfg, state.model, batch_l, batch_u, n_labelled, draws,
                                generator)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grad_norm = _update(cfg, state, mesh, batch_sum=True)
    metrics = {"loss": loss.detach(), **parts}
    if mesh is not None:
        metrics = mesh.reduce_metrics(metrics, batch_sum=True)
    return {**metrics, "grad_norm": grad_norm}


def ss_train_epoch(cfg: PGMConfig, state: PGMTrainState, loader_l, loader_u, n_labelled: int,
                   device: "str | torch.device", generator: Optional[torch.Generator] = None
                   ) -> Dict[str, float]:
    """A semi-supervised epoch: the outer loop over the longer loader, the
    inner one restarted when it runs out (reference ss_train_epoch,
    train_pgm.py:50-108). Returns the loss and aux loss per outer sample."""
    outer, inner = ((loader_u, loader_l) if len(loader_u) > len(loader_l)
                    else (loader_l, loader_u))
    inner_it = iter(inner)
    sums, n = {"loss": 0.0, "aux_loss": 0.0}, 0
    for raw_outer in outer:
        try:
            raw_inner = next(inner_it)
        except StopIteration:
            inner_it = iter(inner)
            raw_inner = next(inner_it)
        b_outer = preprocess_pgm_batch(cfg, raw_outer, device)
        b_inner = preprocess_pgm_batch(cfg, raw_inner, device)
        batch_l, batch_u = (b_outer, b_inner) if outer is loader_l else (b_inner, b_outer)
        m = semi_sup_step(cfg, state, batch_l, batch_u, n_labelled, generator=generator)
        sums["loss"] += float(m["loss"])
        sums["aux_loss"] += float(m["aux_loss"])
        n += b_outer["x"].shape[0]
    return {k: v / max(n, 1) for k, v in sums.items()}


def split_labelled_unlabelled(dataset, sup_frac: float, seed: int = 0):
    """(labelled, unlabelled) parts of ``dataset``: the first
    int(sup_frac N) of a seeded permutation are labelled (reference
    train_pgm.py:287-306)."""
    idx = np.random.default_rng(seed).permutation(len(dataset))
    n_l = int(sup_frac * len(dataset))

    def take(ids):
        return dataclasses.replace(dataset, images=dataset.images[ids],
                                   attrs={k: v[ids] for k, v in dataset.attrs.items()})

    return take(idx[:n_l]), take(idx[n_l:])


@torch.no_grad()
def eval_step(cfg: PGMConfig, model: nn.Module, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The loss and each site's mean log-prob of ``model`` (the EMA) on
    ``batch`` (causal_gen_tpu/pgm/train_pgm.py:323-340)."""
    lps = site_logprobs(cfg, model, batch, train=False)
    n = next(iter(batch.values())).shape[0]
    return {"loss": -sum(torch.sum(v) for v in lps.values()) / n,
            **{k: torch.sum(v) / n for k, v in lps.items()}}


@torch.no_grad()
def predict(model: nn.Module, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The predictors' outputs on ``batch`` (causal_gen_tpu/pgm/train_pgm.py:
    349-358)."""
    return model.predict(batch["x"], **_attrs_only(model, batch))


def pgm_eval_metrics(cfg: PGMConfig, model: nn.Module, loader,
                     device: "str | torch.device") -> Dict[str, float]:
    """Per-variable metrics of the predictors over ``loader``, in the
    attributes' own units (reference eval_epoch, train_pgm.py:174-249)."""
    preds: Dict[str, list] = {k: [] for k in model.dag_variables}
    targets: Dict[str, list] = {k: [] for k in model.dag_variables}
    for raw in loader:
        batch = preprocess_pgm_batch(cfg, raw, device)
        out = predict(model, batch)
        for k in preds:
            targets[k].append(batch[k].cpu().numpy())
            preds[k].append(out[k].cpu().numpy())
    return attribute_metrics(cfg.dataset, {k: np.concatenate(v) for k, v in preds.items()},
                             {k: np.concatenate(v) for k, v in targets.items()})


def save_pgm_checkpoint(path: str, cfg: PGMConfig, state: PGMTrainState,
                        extra: Optional[Dict[str, Any]] = None) -> None:
    """{params, ema_params, opt_state, step} at ``path`` and the config at
    ``path.meta.json`` (reference train_pgm.py:533-546)."""
    cpu = lambda m: {k: v.detach().cpu() for k, v in m.state_dict().items()}  # noqa: E731
    write_payload(os.path.abspath(path),
                  {"params": cpu(state.model), "ema_params": cpu(state.ema),
                   "opt_state": state.optimizer.state_dict(), "step": state.step},
                  {"config": cfg.to_dict(), "extra": extra or {}})


def load_pgm_checkpoint(path: str, device: "str | torch.device" = "cuda"
                        ) -> Tuple[PGMConfig, PGMTrainState, Dict[str, Any]]:
    """(config, state on ``device``, extras) of a ``save_pgm_checkpoint``
    file; the module is rebuilt from the config (``convert.build_pgm``) and
    loads its parameters with ``strict=True``."""
    from causal_gen_tpu_torch.convert import build_pgm

    path = os.path.abspath(path)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    cfg = PGMConfig.from_dict(meta["config"])
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model = build_pgm(cfg.to_dict(), cfg.setup != "sup_pgm", device)
    model.load_state_dict(payload["params"], strict=True)
    state = init_pgm_state(cfg, model)
    state.ema.load_state_dict(payload["ema_params"], strict=True)
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    return cfg, state, meta.get("extra", {})


def train_pgm(cfg: PGMConfig, model: nn.Module, loaders: Dict[str, Any],
              device: "str | torch.device", epochs: Optional[int] = None,
              save_dir: Optional[str] = None) -> Tuple[PGMTrainState, Dict[str, float]]:
    """The supervised training run (reference train_pgm.py:430-567): train
    epochs, an evaluation of the EMA every ``eval_freq`` epochs, and a
    checkpoint at ``save_dir/checkpoint`` on each best valid loss."""
    state = init_pgm_state(cfg, model)
    best = float("inf")
    history: Dict[str, float] = {}
    for epoch in range(1, (epochs or cfg.epochs) + 1):
        losses = [train_step(cfg, state, preprocess_pgm_batch(cfg, raw, device))["loss"]
                  for raw in loaders["train"]]
        history["train_loss"] = float(torch.stack(losses).mean())
        if epoch % cfg.eval_freq == 0:
            ev = [eval_step(cfg, state.ema, preprocess_pgm_batch(cfg, raw, device))["loss"]
                  for raw in loaders["valid"]]
            history["valid_loss"] = float(torch.stack(ev).mean())
            if history["valid_loss"] < best:
                best = history["valid_loss"]
                if save_dir:
                    save_pgm_checkpoint(os.path.join(save_dir, "checkpoint"), cfg, state,
                                        extra={"epoch": epoch, "best_loss": best})
        log.info("epoch %d | %s", epoch, history)
    return state, history
