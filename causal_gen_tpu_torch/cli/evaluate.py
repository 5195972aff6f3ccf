"""Counterfactual effectiveness evaluation CLI of the port.

Counterpart of ``causal_gen_tpu/cli/evaluate.py`` (reference
notebooks/eval_example.ipynb as a script), with ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path):

    python -m causal_gen_tpu_torch.cli.evaluate --pgm_path P --predictor_path A \\
        --vae_path V --data_dir DIR [--cf_path CF] [--do_pa thickness] \\
        [--seeds 0 1 2] [--device cuda]

It loads the three mechanisms (the port's checkpoints; ``--cf_path`` a CF
checkpoint, whose EMA fine-tuned VAE is then evaluated), sweeps
interventions over the test set (``eval/cf_eval.py``) and prints the
per-variable metrics in physical units, and on Morpho-MNIST the measured
morphometric MAEs, as a mean and std over the seeds, in one JSON object.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np

from causal_gen_tpu_torch import resolve_device
from causal_gen_tpu_torch.cli.train_cf import build_pgm_from_ckpt, build_vae_from_ckpt
from causal_gen_tpu_torch.data.datasets import make_datasets
from causal_gen_tpu_torch.data.loader import Loader
from causal_gen_tpu_torch.eval.cf_eval import eval_cf_loop
from causal_gen_tpu_torch.utils.cache import setup_compilation_cache


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Counterfactual effectiveness evaluation with "
                                            "PyTorch.")
    p.add_argument("--pgm_path", required=True)
    p.add_argument("--predictor_path", required=True)
    p.add_argument("--vae_path", required=True)
    p.add_argument("--cf_path", default="",
                   help="a CF fine-tuning checkpoint: evaluate its EMA fine-tuned VAE instead "
                        "of the VAE checkpoint's")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--data_dir", default="")
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--do_pa", default=None)
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--no_measure", action="store_true",
                   help="skip the morphometric re-measurement")
    p.add_argument("--te_cf", action="store_true",
                   help="cond_prior total effect: decode the alpha-mixture abduction's latents")
    p.add_argument("--abduct_alpha", type=float, default=0.65)
    return p


def main(argv: Optional[list] = None, datasets: Optional[Dict] = None) -> Dict:
    """Evaluate and print the result; returns it. ``datasets`` replaces the
    files under ``--data_dir`` with in-memory ``ArrayDataset``s (train and
    test), or is a function of the data config that makes them."""
    setup_compilation_cache()  # this host's build directory (utils/cache.py)
    args, _ = build_parser().parse_known_args(argv)
    device = resolve_device(args.device)
    pgm_cfg, pgm, _ = build_pgm_from_ckpt(args.pgm_path, device)
    _, predictor, _ = build_pgm_from_ckpt(args.predictor_path, device)
    vae_cfg, vae, _ = build_vae_from_ckpt(args.vae_path, device, args.data_dir)
    if args.cf_path:
        import torch

        from causal_gen_tpu_torch.pgm.train_cf import load_cf_meta

        _, cf_extra = load_cf_meta(args.cf_path)
        payload = torch.load(args.cf_path, map_location="cpu", weights_only=True)
        vae.load_state_dict(payload["ema_vae"], strict=True)
        print(f"evaluating the CF fine-tuned VAE of {args.cf_path} (epoch "
              f"{cf_extra.get('epoch')})")
    # the PGM's variables, UK Biobank's in [-1, 1] (the PGM's space, which
    # the sweep feeds to the PGM as it is)
    data_cfg = vae_cfg
    if pgm_cfg.parents_x:
        data_cfg = data_cfg.replace(parents_x=tuple(pgm_cfg.parents_x))
    if "ukbb" in vae_cfg.name:
        data_cfg = data_cfg.replace(context_norm="[-1,1]")
    datasets = make_datasets(datasets, data_cfg)
    loader = Loader(datasets["test"], args.bs, shuffle=False, drop_last=False, concat_pa=False,
                    max_batches=args.max_batches)
    train_attrs = {k: np.asarray(v) for k, v in datasets["train"].attrs.items()}
    results = eval_cf_loop(vae_cfg, vae, pgm, predictor, loader, train_attrs, device,
                           seeds=tuple(args.seeds), do_pa=args.do_pa,
                           measure=not args.no_measure, te_cf=args.te_cf,
                           alpha=args.abduct_alpha)
    # DAG variables the VAE is not conditioned on cannot move through the
    # image: their rows measure the PGM's counterfactual alone
    out = {"metrics": {k: {"mean": v[0], "std": v[1]} for k, v in results.items()},
           "units": "physical (volumes in ml, age in years; train_cf.py:63-108 conventions)",
           "non_image_parents_expected_invariant": sorted(set(pgm.dag_variables)
                                                          - set(vae_cfg.parents_x))}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
