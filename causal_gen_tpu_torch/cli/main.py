"""HVAE training CLI of the port.

Counterpart of ``causal_gen_tpu/cli/main.py`` (reference src/main.py), with
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path):

    python -m causal_gen_tpu_torch.cli.main --hps morphomnist --data_dir DIR \\
        --epochs 10 [--device cuda] [--max_batches N] [--save_dir DIR]
    python -m causal_gen_tpu_torch.cli.main --hps morphomnist --cond_prior ...
    python -m causal_gen_tpu_torch.cli.main --hps vol3d32 --epochs 1   # 3-D, no files

``--cond_prior`` (with the registry's ``cond_drop_from``) and
``--q_correction`` reach the HVAE; ``--hps vol3d32`` trains the 3-D HVAE on
the generated sphere volumes; ``--vae simple`` trains the single-latent
``SimpleVAE`` instead (with ``--x_like diag_gauss``, its logit-Normal head):

    python -m causal_gen_tpu_torch.cli.main --hps morphomnist --vae simple \
        --x_like diag_gauss --data_dir DIR --epochs 10

``--remat`` rematerialises the HVAE's blocks at resolutions of at least
``--remat_min_res`` in the backward, with ``--stage_scan`` picking JAX's unit
(a whole decoder block of a scanned run, its draw replayed; see
``models/hvae.py``); the flagships train so at bs 128:

    python -m causal_gen_tpu_torch.cli.main --hps ukbb192 --data_dir DIR --bs 128 \
        --stage_scan --remat --remat_min_res 48

Fields of the JAX CLI that only steer the JAX programs (``--use_pallas``,
``--steps_per_call``, the mesh) are accepted and go into the stored config;
the port's step ignores them.

Every ``viz_freq`` iterations (in whole epochs), and at the early iterations
start+1 and start+2^n, the EMA model draws ``utils/viz.py::write_images`` on
the first ``min(context_dim * 5, bs)`` valid images into
``<save_dir>/viz-<epoch>.png``; a failure there (PIL missing, say) is logged
and training goes on, as in the JAX CLI. ``--viz_freq 0`` turns it off.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from causal_gen_tpu_torch import resolve_device
from causal_gen_tpu_torch.config import get_config
from causal_gen_tpu_torch.data.datasets import make_datasets
from causal_gen_tpu_torch.data.loader import setup_loaders
from causal_gen_tpu_torch.models.simple_vae import build_vae
from causal_gen_tpu_torch.train.checkpoint import load_checkpoint, restore_train_state
from causal_gen_tpu_torch.train.experiment import MetricWriter, setup_directories, setup_logging
from causal_gen_tpu_torch.train.vae_trainer import train
from causal_gen_tpu_torch.utils.viz import write_images


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the image mechanism (HVAE or SimpleVAE) "
                                            "with PyTorch.")
    p.add_argument("--hps", default="morphomnist", help="config registry name")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--exp_name", default="")
    p.add_argument("--data_dir", default="")
    p.add_argument("--save_dir", default="")
    p.add_argument("--resume", default="", help="checkpoint path to resume")
    p.add_argument("--seed", type=int)
    p.add_argument("--max_batches", type=int, default=None,
                   help="cap batches/epoch (smoke runs)")
    p.add_argument("--epochs", type=int)
    p.add_argument("--bs", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument("--lr_warmup_steps", type=int)
    p.add_argument("--wd", type=float)
    p.add_argument("--beta", type=float)
    p.add_argument("--beta_warmup_steps", type=int)
    p.add_argument("--accu_steps", type=int)
    p.add_argument("--eval_freq", type=int)
    p.add_argument("--viz_freq", type=int)
    p.add_argument("--vae", choices=["hierarchical", "simple"])
    p.add_argument("--x_like", type=str)
    p.add_argument("--z_max_res", type=int)
    p.add_argument("--cond_prior", action="store_true", default=None)
    p.add_argument("--q_correction", action="store_true", default=None)
    p.add_argument("--kl_free_bits", type=float)
    # architecture overrides (reference hps.py:180-205 exposes the arch DSL)
    p.add_argument("--enc_arch", type=str)
    p.add_argument("--dec_arch", type=str)
    p.add_argument("--widths", nargs="+", type=int)
    p.add_argument("--input_res", type=int)
    p.add_argument("--pad", type=int)
    p.add_argument("--z_dim", type=int)
    p.add_argument("--bias_max_res", type=int)
    p.add_argument("--dtype", choices=["float32", "bfloat16"])
    p.add_argument("--use_pallas", action="store_true", default=None)
    p.add_argument("--stage_scan", action="store_true", default=None)
    p.add_argument("--remat", action="store_true", default=None)
    p.add_argument("--remat_min_res", type=int)
    p.add_argument("--width_multiple", type=int)
    p.add_argument("--steps_per_call", type=int)
    p.add_argument("--posterior_init_scale", type=float,
                   help="init scale of posterior-head convs; 0 makes q==p at init")
    p.add_argument("--grad_clip", type=float)
    p.add_argument("--grad_skip", type=float,
                   help="skip the update when grad norm exceeds this (reference hps.py:142)")
    return p


# fields a resumed run takes from the command line; the rest from the checkpoint
_RESUME_OVERRIDES = ("lr", "epochs", "data_dir", "eval_freq", "viz_freq")


def main(argv: Optional[list] = None, datasets: Optional[Dict] = None) -> Tuple:
    """Train; returns (state, history). ``datasets`` replaces the files under
    ``--data_dir`` with in-memory ``ArrayDataset``s (train/valid), or is a
    function of the run's config that makes them."""
    args, _ = build_parser().parse_known_args(argv)
    device = resolve_device(args.device)
    overrides = {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in vars(args).items()
        if v is not None and v != ""
        and k not in ("hps", "device", "resume", "save_dir", "exp_name", "max_batches")
    }
    payload = None
    if args.resume and os.path.exists(args.resume + ".meta.json"):
        # the config stored with the checkpoint is authoritative (main.py:31-36)
        cfg, payload, _ = load_checkpoint(args.resume)
        cfg = cfg.replace(**{k: v for k, v in overrides.items() if k in _RESUME_OVERRIDES})
    else:
        cfg = get_config(args.hps, **overrides)
    save_dir = args.save_dir or os.path.join("checkpoints", cfg.name, args.exp_name or "default")
    setup_directories(save_dir)
    logger = setup_logging(save_dir)
    writer = MetricWriter(save_dir)
    writer.add_hparams(cfg.to_dict())
    logger.info("device: %s%s", device,
                f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")

    datasets = make_datasets(datasets, cfg)
    loaders = setup_loaders(datasets, cfg.bs, seed=cfg.seed, max_batches=args.max_batches)
    model = build_vae(cfg, device=device, generator=torch.Generator().manual_seed(cfg.seed))
    init_state = None if payload is None else restore_train_state(cfg, model, payload)
    viz_batch = datasets["valid"].batch(np.arange(min(cfg.context_dim * 5, cfg.bs)))
    # viz_freq counts iterations; whole epochs run between callbacks
    steps_per_epoch = max(1, len(loaders["train"]))
    viz_epoch_freq = max(1, round(cfg.viz_freq / steps_per_epoch)) if cfg.viz_freq else 0
    # the early cadence (reference trainer.py:89-91, 124): an epoch that
    # holds iteration start+1 or start+2^n, n in 3..13, also draws
    start_iter = init_state.step if init_state is not None else 0
    early_iters = {start_iter + 1} | {start_iter + 2**n for n in range(3, 14)}

    def is_early(epoch: int) -> bool:
        lo, hi = (epoch - 1) * steps_per_epoch, epoch * steps_per_epoch
        return any(lo < it <= hi for it in early_iters)

    def callback(epoch, state, hist):
        writer.add_scalars(hist, epoch)
        if viz_epoch_freq and (epoch % viz_epoch_freq == 0 or is_early(epoch)):
            try:
                write_images(cfg, state.ema, viz_batch,
                             os.path.join(save_dir, f"viz-{epoch}.png"))
            except Exception as e:  # viz never stops training
                logger.warning("viz failed: %s", e)

    try:
        state, history = train(cfg, model, loaders, save_dir=save_dir, callback=callback,
                               init_state=init_state)
    finally:
        writer.close()
    logger.info("done: %s", history)
    return state, history


if __name__ == "__main__":
    main()
