"""PGM and anticausal-predictor training CLI of the port.

Counterpart of ``causal_gen_tpu/cli/train_pgm.py`` (reference
src/pgm/train_pgm.py:313-567), with ``--device`` (default ``cuda``; ``cpu``
runs on the CPU):

    python -m causal_gen_tpu_torch.cli.train_pgm --dataset morphomnist \\
        --setup sup_pgm|sup_aux|semi_sup --data_dir DIR [--device cuda] \\
        [--epochs N] [--max_batches N] [--save_dir DIR]

``sup_pgm`` trains the SCM's nets, ``sup_aux`` the anticausal predictors,
``semi_sup`` both on a ``--sup_frac`` labelled split. The best (``sup_*``)
or latest (``semi_sup``) state goes to ``<save_dir>/checkpoint``
(``pgm/train_pgm.py::save_pgm_checkpoint``); the predictors' metrics follow
a ``sup_aux`` or ``semi_sup`` run. After ``sup_pgm`` on Morpho-MNIST the
joint plots of 512 samples of the EMA PGM and of the train set's
morphometrics go to ``joint_samples.png`` and ``joint_data.png``
(``utils/plots.py::plot_joint``; nothing is drawn without matplotlib,
seaborn and pandas).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Tuple

import torch

from causal_gen_tpu_torch import resolve_device
from causal_gen_tpu_torch.config import get_config
from causal_gen_tpu_torch.convert import build_pgm as build_pgm_from_config
from causal_gen_tpu_torch.data.datasets import make_datasets
from causal_gen_tpu_torch.data.loader import Loader, setup_loaders
from causal_gen_tpu_torch.pgm.train_pgm import (
    SETUPS,
    PGMConfig,
    PGMTrainState,
    init_pgm_state,
    pgm_eval_metrics,
    save_pgm_checkpoint,
    split_labelled_unlabelled,
    ss_train_epoch,
    train_pgm,
)
from causal_gen_tpu_torch.train.experiment import MetricWriter, setup_directories, setup_logging
from causal_gen_tpu_torch.utils.cache import setup_compilation_cache
from causal_gen_tpu_torch.utils.plots import plot_joint

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a PGM / the anticausal predictors with PyTorch.")
    p.add_argument("--dataset", default="morphomnist")
    p.add_argument("--setup", default="sup_pgm", choices=list(SETUPS))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--exp_name", default="")
    p.add_argument("--data_dir", default="")
    p.add_argument("--save_dir", default="")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--max_batches", type=int, default=None,
                   help="cap batches/epoch (smoke runs)")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=0.1)
    p.add_argument("--input_res", type=int, default=32)
    p.add_argument("--input_channels", type=int, default=1)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--widths", nargs="+", type=int, default=[32, 32])
    p.add_argument("--parents_x", nargs="+", default=[])
    p.add_argument("--alpha", type=float, default=1e-3)
    p.add_argument("--std_fixed", type=float, default=0.0)
    p.add_argument("--sup_frac", type=float, default=1.0)
    p.add_argument("--corrupt_p", type=float, default=0.0,
                   help="cmnist train-label corruption fraction (reference datasets.py:325)")
    p.add_argument("--context_norm", default=None,
                   help="dataset attribute normalisation; UK Biobank PGM training wants 'raw' "
                        "(the batch preprocessing maps to [-1, 1] itself)")
    return p


def build_pgm(cfg: PGMConfig, device: "str | torch.device") -> torch.nn.Module:
    """The ``PGM_REGISTRY`` class of ``cfg.dataset`` in ``cfg.setup``'s role
    (causal_gen_tpu/cli/train_pgm.py::build_pgm), initialised from
    ``cfg.seed``."""
    return build_pgm_from_config(cfg.to_dict(), cfg.setup != "sup_pgm", device,
                                 generator=torch.Generator().manual_seed(cfg.seed))


def data_config(cfg: PGMConfig, args: argparse.Namespace):
    """The image config whose datasets the PGM trains on (the JAX CLI's
    choice): the dataset's own for Morpho-MNIST and Colour-MNIST, ukbb64 or
    mimic192 at ``--input_res`` otherwise."""
    over = {"data_dir": args.data_dir}
    if args.parents_x:
        over["parents_x"] = tuple(args.parents_x)
    if args.context_norm:
        over["context_norm"] = args.context_norm
    if args.corrupt_p:
        over["corrupt_p"] = args.corrupt_p
    if cfg.dataset in ("morphomnist", "cmnist"):
        return get_config(cfg.dataset, **over)
    return get_config("ukbb64" if "ukbb" in cfg.dataset else "mimic192",
                      input_res=args.input_res, **over)


def run_semi_sup(cfg: PGMConfig, model: torch.nn.Module, datasets: Dict, args,
                 save_dir: str, device: torch.device) -> Tuple[PGMTrainState, Dict[str, float]]:
    """The labelled / unlabelled split and the interleaved epochs
    (reference train_pgm.py:287-306, 430-470); a checkpoint every
    ``eval_freq`` epochs."""
    ds_l, ds_u = split_labelled_unlabelled(datasets["train"], cfg.sup_frac, seed=cfg.seed)
    loader_l = Loader(ds_l, cfg.bs, seed=cfg.seed, concat_pa=False, max_batches=args.max_batches)
    loader_u = Loader(ds_u, cfg.bs, seed=cfg.seed + 1, concat_pa=False,
                      max_batches=args.max_batches)
    state = init_pgm_state(cfg, model)
    generator = torch.Generator().manual_seed(cfg.seed)
    history: Dict[str, float] = {}
    for epoch in range(1, cfg.epochs + 1):
        stats = ss_train_epoch(cfg, state, loader_l, loader_u, len(ds_l), device, generator)
        history = {f"train_{k}": v for k, v in stats.items()}
        if save_dir and epoch % cfg.eval_freq == 0:
            save_pgm_checkpoint(os.path.join(save_dir, "checkpoint"), cfg, state,
                                extra={"epoch": epoch})
    return state, history


def main(argv: Optional[list] = None, datasets: Optional[Dict] = None
         ) -> Tuple[PGMTrainState, Dict[str, float]]:
    """Train; returns (state, history). ``datasets`` replaces the files under
    ``--data_dir`` with in-memory ``ArrayDataset``s (train/valid), or is a
    function of the data config (``data_config``) that makes them."""
    setup_compilation_cache()  # this host's build directory (utils/cache.py)
    args, _ = build_parser().parse_known_args(argv)
    device = resolve_device(args.device)
    cfg = PGMConfig(dataset=args.dataset, setup=args.setup, seed=args.seed, epochs=args.epochs,
                    bs=args.bs, lr=args.lr, wd=args.wd, input_res=args.input_res,
                    input_channels=args.input_channels, eval_freq=args.eval_freq,
                    widths=tuple(args.widths), parents_x=tuple(args.parents_x),
                    alpha=args.alpha, std_fixed=args.std_fixed, sup_frac=args.sup_frac)
    save_dir = args.save_dir or os.path.join("checkpoints", f"{cfg.setup}_{cfg.dataset}",
                                             args.exp_name or "default")
    setup_directories(save_dir)
    logger = setup_logging(save_dir)
    writer = MetricWriter(save_dir)
    writer.add_hparams(cfg.to_dict())
    datasets = make_datasets(datasets, data_config(cfg, args))
    loaders = setup_loaders(datasets, cfg.bs, seed=cfg.seed, max_batches=args.max_batches,
                            concat_pa=False)
    model = build_pgm(cfg, device)
    try:
        if cfg.setup == "semi_sup":
            state, history = run_semi_sup(cfg, model, datasets, args, save_dir, device)
        else:
            state, history = train_pgm(cfg, model, loaders, device, save_dir=save_dir)
        writer.add_scalars(history, cfg.epochs)
        if cfg.setup != "sup_pgm":
            metrics = pgm_eval_metrics(cfg, state.ema, loaders["valid"], device)
            logger.info("eval metrics: %s", metrics)
            writer.add_scalars(metrics, cfg.epochs, prefix="eval/")
            history = {**history, **{f"eval/{k}": v for k, v in metrics.items()}}
        elif cfg.dataset == "morphomnist":
            # sampled against data morphometrics (reference train_pgm.py:502-504)
            with torch.no_grad():
                samples = state.ema.sample(512, generator=torch.Generator().manual_seed(cfg.seed))
            plot_joint(samples["thickness"].cpu().numpy(), samples["intensity"].cpu().numpy(),
                       "pgm samples", save_path=os.path.join(save_dir, "joint_samples.png"))
            dt = datasets["train"]
            plot_joint(dt.attrs["thickness"], dt.attrs["intensity"], "data",
                       save_path=os.path.join(save_dir, "joint_data.png"))
    finally:
        writer.close()
    return state, history


if __name__ == "__main__":
    main()
