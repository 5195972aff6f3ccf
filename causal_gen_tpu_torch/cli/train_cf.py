"""Counterfactual fine-tuning CLI of the port (stage 3).

Counterpart of ``causal_gen_tpu/cli/train_cf.py`` (reference
src/pgm/train_cf.py:223-538), with ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path):

    python -m causal_gen_tpu_torch.cli.train_cf --pgm_path P --predictor_path A \\
        --vae_path V --data_dir DIR [--device cuda] [--epochs N] [--bs 16] \\
        [--wd 0.05] [--cf_remat] [--max_batches N] [--save_dir DIR] [--resume CKPT]

It merges the three mechanisms, each rebuilt from its own checkpoint (the
port's: ``cli/main.py`` and ``cli/train_pgm.py`` write them,
``convert.save_mechanism_checkpoints`` carries JAX ones across), into the
DSCM, and trains the VAE and λ (``pgm/train_cf.py``): the constraint eps is
the VAE checkpoint's best ELBO unless ``--elbo_constraint`` is given, the
data come from the PGM's variables (UK Biobank's raw, mapped per batch), the
soft-thickness calibration is fitted on train images when
``--thickness_weight`` > 0. Every ``eval_freq`` epochs the state is saved,
then swept on the valid set under do(pa_k) for each variable and under a
random one, whose loss picks the best save (``<save_dir>/checkpoint``).
``--resume`` takes a CF checkpoint, whose config holds but for the run
control (``--epochs``, ``--eval_freq``, ``--accu_steps``,
``--steps_per_call``, ``--cf_remat``). After each evaluation the EMA draws
the counterfactual panel of one valid batch under a random intervention
(observation, counterfactual, direct effect and, with ``--cf_particles`` > 1,
the uncertainty) into ``cf_panel_<epoch>.png`` (``utils/plots.py::plot_cf``;
nothing is drawn without matplotlib, and a failure is logged, as in JAX).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from causal_gen_tpu_torch import resolve_device
from causal_gen_tpu_torch.data.datasets import make_datasets
from causal_gen_tpu_torch.data.loader import setup_loaders
from causal_gen_tpu_torch.models.simple_vae import build_vae
from causal_gen_tpu_torch.pgm.dscm import DSCM
from causal_gen_tpu_torch.pgm.train_cf import (
    CFConfig,
    CFTrainState,
    cf_eval_epoch,
    cf_state_payload,
    cf_train_epoch,
    init_cf_state,
    load_cf_meta,
    make_cf_eval_step,
    random_intervention,
    restore_cf_state,
)
from causal_gen_tpu_torch.pgm.train_pgm import load_pgm_checkpoint, preprocess_pgm_batch
from causal_gen_tpu_torch.train.checkpoint import CheckpointWriter, load_checkpoint
from causal_gen_tpu_torch.train.experiment import MetricWriter, setup_directories, setup_logging
from causal_gen_tpu_torch.utils.cache import setup_compilation_cache
from causal_gen_tpu_torch.utils.plots import plot_cf

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Counterfactual DSCM fine-tuning with PyTorch.")
    p.add_argument("--pgm_path", required=True)
    p.add_argument("--predictor_path", required=True)
    p.add_argument("--vae_path", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--exp_name", default="")
    p.add_argument("--data_dir", default="")
    p.add_argument("--save_dir", default="")
    p.add_argument("--resume", default="", help="CF checkpoint to resume")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--max_batches", type=int, default=None,
                   help="cap batches/epoch (smoke runs)")
    # None so that a resume tells a given flag from the default; a fresh run
    # takes 5000
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=None,
                   help="weight decay; the VAE checkpoint's wd by default (the reference "
                        "CF launch sets 0.1, pgm/run.sh:25-37)")
    p.add_argument("--lr_lagrange", type=float, default=1e-2)
    p.add_argument("--ema_rate", type=float, default=0.999)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--lmbda_init", type=float, default=0.0)
    p.add_argument("--damping", type=float, default=100.0)
    p.add_argument("--do_pa", default=None)
    p.add_argument("--eval_freq", type=int, default=None)  # 1 for a fresh run
    p.add_argument("--cf_particles", type=int, default=1)
    p.add_argument("--accu_steps", type=int, default=None,
                   help="microbatches an update (effective batch bs, live activations "
                        "bs / accu_steps)")
    p.add_argument("--steps_per_call", type=int, default=None,
                   help="accepted and stored; the port runs updates one at a time")
    p.add_argument("--cf_remat", action="store_true", default=None,
                   help="recompute each HVAE pass in the backward instead of keeping its "
                        "activations")
    p.add_argument("--elbo_constraint", type=float, default=None,
                   help="eps; the VAE checkpoint's best valid ELBO by default")
    p.add_argument("--thickness_weight", type=float, default=0.0,
                   help="soft measured-thickness penalty weight (Morpho-MNIST)")
    p.add_argument("--intensity_weight", type=float, default=0.0,
                   help="soft measured-intensity penalty weight (Morpho-MNIST)")
    p.add_argument("--calib_n", type=int, default=512,
                   help="train images the soft-thickness calibration is fitted on")
    return p


def build_pgm_from_ckpt(path: str, device: "str | torch.device"):
    """(config, the EMA module, extras) of a PGM or predictor checkpoint
    (``pgm/train_pgm.py::load_pgm_checkpoint``): the module in its
    checkpoint's role, frozen by the DSCM."""
    cfg, state, extra = load_pgm_checkpoint(path, device)
    return cfg, state.ema, extra


def build_vae_from_ckpt(path: str, device: "str | torch.device", data_dir: str = ""):
    """(config, the image mechanism with the checkpoint's EMA weights,
    extras) of a ``cli/main.py`` checkpoint."""
    cfg, payload, extra = load_checkpoint(path)
    if data_dir:
        cfg = cfg.replace(data_dir=data_dir)
    vae = build_vae(cfg, device=device)
    vae.load_state_dict(payload["ema_params"], strict=True)
    return cfg, vae, extra


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().transpose(0, *range(2, t.dim()), 1)


def cf_panel(cfg: CFConfig, pgm_cfg, state: CFTrainState, loaders: Dict,
             device: torch.device, dag_vars: Tuple[str, ...], epoch: int, save_path: str):
    """The counterfactual panel of the EMA on the first valid batch under a
    random intervention (causal_gen_tpu/cli/train_cf.py:275-305); with
    ``cf_particles`` > 1 a second forward gives the variance map."""
    vbatch = preprocess_pgm_batch(pgm_cfg, next(iter(loaders["valid"])), device)
    vdo = random_intervention(np.random.default_rng(epoch), dag_vars, vbatch, cfg.do_pa)
    generator = torch.Generator().manual_seed(cfg.seed + 10**6 + epoch)
    _, _, vcfs = make_cf_eval_step(cfg, state.ema)(vbatch, vdo, generator=generator)
    var = None
    if cfg.cf_particles > 1:
        with torch.inference_mode():
            out = state.ema.forward(vbatch, vdo, cf_particles=cfg.cf_particles, beta=cfg.beta,
                                    generator=generator)
        var = out.get("var_cf_x")
    return plot_cf(_nhwc(vbatch["x"]), _nhwc(vcfs["x"]), None if var is None else _nhwc(var),
                   save_path=save_path)


def main(argv: Optional[list] = None, datasets: Optional[Dict] = None
         ) -> Tuple[CFTrainState, Dict[str, float]]:
    """Train; returns (state, history). ``datasets`` replaces the files under
    ``--data_dir`` with in-memory ``ArrayDataset``s (train/valid), or is a
    function of the data config that makes them."""
    setup_compilation_cache()  # this host's build directory (utils/cache.py)
    args, _ = build_parser().parse_known_args(argv)
    device = resolve_device(args.device)
    pgm_cfg, pgm, _ = build_pgm_from_ckpt(args.pgm_path, device)
    _, predictor, _ = build_pgm_from_ckpt(args.predictor_path, device)
    vae_cfg, vae, vae_extra = build_vae_from_ckpt(args.vae_path, device, args.data_dir)
    eps = (args.elbo_constraint if args.elbo_constraint is not None
           else float(vae_extra.get("best_loss", 0.0)))
    cfg = CFConfig(
        seed=args.seed, epochs=args.epochs or 5000, bs=args.bs, lr=args.lr,
        lr_lagrange=args.lr_lagrange, ema_rate=args.ema_rate, alpha=args.alpha,
        lmbda_init=args.lmbda_init, damping=args.damping, do_pa=args.do_pa,
        eval_freq=args.eval_freq or 1, cf_particles=args.cf_particles,
        beta=vae_cfg.beta, grad_clip=vae_cfg.grad_clip, grad_skip=vae_cfg.grad_skip,
        wd=args.wd if args.wd is not None else vae_cfg.wd, betas=tuple(vae_cfg.betas),
        elbo_constraint=eps, thickness_weight=args.thickness_weight,
        intensity_weight=args.intensity_weight, accu_steps=args.accu_steps or 1,
        steps_per_call=args.steps_per_call or 1, cf_remat=bool(args.cf_remat))
    save_dir = args.save_dir or os.path.join("checkpoints", f"cf_{pgm_cfg.dataset}",
                                             args.exp_name or "default")
    setup_directories(save_dir)
    logger = setup_logging(save_dir)
    writer = MetricWriter(save_dir)
    ckpt_writer = CheckpointWriter(save_dir)

    payload = None
    start_epoch = 1
    if args.resume and os.path.exists(args.resume + ".meta.json"):
        # both optimizer states come back (reference train_cf.py:460-471); the
        # checkpoint's config holds (morph weights and calibration included)
        # but for the run control
        cfg, extra = load_cf_meta(args.resume)
        payload = torch.load(os.path.abspath(args.resume), map_location="cpu", weights_only=True)
        start_epoch = int(extra.get("epoch", 0)) + 1
        run = {k: v for k, v in (("epochs", args.epochs), ("eval_freq", args.eval_freq),
                                 ("accu_steps", args.accu_steps),
                                 ("steps_per_call", args.steps_per_call),
                                 ("cf_remat", args.cf_remat)) if v is not None}
        cfg = dataclasses.replace(cfg, **run)
        logger.info("resuming from %s at epoch %d", args.resume, start_epoch)

    # the data follow the PGM's variables, not the VAE's (reference
    # train_cf.py:425-427); UK Biobank's attributes load raw and the batch
    # preprocessing maps them to [-1, 1]
    data_cfg = vae_cfg
    if pgm_cfg.parents_x:
        data_cfg = data_cfg.replace(parents_x=tuple(pgm_cfg.parents_x))
    if "ukbb" in vae_cfg.name:
        data_cfg = data_cfg.replace(context_norm="raw")
    datasets = make_datasets(datasets, data_cfg)
    loaders = setup_loaders(datasets, cfg.bs, seed=cfg.seed, concat_pa=False,
                            max_batches=args.max_batches)

    if cfg.thickness_weight > 0 and tuple(cfg.thickness_calib) == (1.0, 0.0):
        from causal_gen_tpu_torch.ops.soft_morph import calibrate_soft_thickness

        x01 = np.asarray(datasets["train"].images[: args.calib_n], np.float32)[..., 0] / 255.0
        calib, fit_mae = calibrate_soft_thickness(x01, device=device)
        cfg = dataclasses.replace(cfg, thickness_calib=calib)
        logger.info("soft-thickness calib a=%.4f b=%.4f (fit MAE %.3f px)",
                    calib[0], calib[1], fit_mae)

    dscm = DSCM(vae_cfg, pgm, predictor, vae, elbo_constraint=cfg.elbo_constraint,
                lmbda_init=cfg.lmbda_init, damping=cfg.damping,
                thickness_weight=cfg.thickness_weight, intensity_weight=cfg.intensity_weight,
                thickness_calib=tuple(cfg.thickness_calib), remat=cfg.cf_remat)
    state = init_cf_state(cfg, dscm)
    if payload is not None:
        restore_cf_state(state, payload)
    generator = torch.Generator().manual_seed(cfg.seed)
    host_rng = np.random.default_rng(cfg.seed)
    dag_vars = tuple(pgm.dag_variables)
    history: Dict[str, float] = {}

    def save(epoch: int) -> str:
        return ckpt_writer.save(cf_state_payload(state),
                                {"config": cfg.to_dict(), "extra": {"epoch": epoch}},
                                step=state.step)

    try:
        for epoch in range(start_epoch, cfg.epochs + 1):
            stats = cf_train_epoch(cfg, pgm_cfg, state, loaders["train"], device, host_rng,
                                   generator)
            logger.info("epoch %d | %s", epoch, stats)
            writer.add_scalars(stats, epoch, prefix="train/")
            history = {f"train/{k}": v for k, v in stats.items()}
            if epoch % cfg.eval_freq:
                continue
            # saved before the long sweeps; the random-do sweep's loss then
            # picks the best save (reference train_cf.py:510-517)
            path = save(epoch)
            for pa_k in dag_vars + (None,):
                ev, metrics = cf_eval_epoch(cfg, pgm_cfg, state, loaders, device, do_pa=pa_k,
                                            generator=torch.Generator().manual_seed(
                                                cfg.seed + epoch))
                logger.info("valid do(%s) | %s | %s", pa_k, ev, metrics)
                writer.add_scalars(metrics, epoch, prefix=f"valid_do_{pa_k}/")
                history.update({f"valid_do_{pa_k}/{k}": v for k, v in {**ev, **metrics}.items()})
                if pa_k is None:
                    ckpt_writer.update_metric(ev["loss"], path=path)
            try:
                cf_panel(cfg, pgm_cfg, state, loaders, device, dag_vars, epoch,
                         os.path.join(save_dir, f"cf_panel_{epoch}.png"))
            except Exception as e:  # viz never stops training
                logger.warning("cf panel failed: %s", e)
        if cfg.epochs % cfg.eval_freq:
            save(cfg.epochs)  # a short run with a sparse evaluation still keeps its state
    finally:
        writer.close()
    return state, history


if __name__ == "__main__":
    main()
