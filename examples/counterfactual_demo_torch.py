#!/usr/bin/env python
"""Counterfactual generation demo with the PyTorch port.

The twin of ``examples/counterfactual_demo.py``: load the three trained
mechanisms, take test images, apply the named interventions, and render an
observation / counterfactual / direct-effect / uncertainty panel
(``causal_gen_tpu_torch/utils/plots.py::plot_cf``; no figure without
matplotlib, the counterfactual parents are printed all the same).

The mechanisms come from the port's checkpoints (``cli/main.py`` and
``cli/train_pgm.py`` write them; ``convert.save_mechanism_checkpoints``
carries a JAX DSCM's across) or from one ``convert.save_converted`` file.

Usage:
  python examples/counterfactual_demo_torch.py \
      --pgm_path PGM/checkpoint --predictor_path AUX/checkpoint \
      --vae_path VAE/checkpoint --data_dir DIR --do thickness=0.8 \
      --out cf_panel.png [--device cpu]
  python examples/counterfactual_demo_torch.py --converted dscm.pt --data_dir DIR \
      --do digit=3
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def parse_do(spec: str):
    k, v = spec.split("=")
    return k, float(v)


def load_dscm(args, device):
    """(the DSCM, its PGM's config) from ``--converted`` or the three
    checkpoint paths."""
    from causal_gen_tpu_torch.pgm.dscm import DSCM
    from causal_gen_tpu_torch.pgm.train_pgm import PGMConfig

    if args.converted:
        from causal_gen_tpu_torch.convert import load_converted

        payload = torch.load(args.converted, map_location="cpu", weights_only=True)
        return (load_converted(args.converted, device),
                PGMConfig.from_dict(payload["configs"]["pgm"]))
    from causal_gen_tpu_torch.cli.train_cf import build_pgm_from_ckpt, build_vae_from_ckpt

    pgm_cfg, pgm, _ = build_pgm_from_ckpt(args.pgm_path, device)
    _, predictor, _ = build_pgm_from_ckpt(args.predictor_path, device)
    vae_cfg, vae, _ = build_vae_from_ckpt(args.vae_path, device)
    return DSCM(vae_cfg, pgm, predictor, vae), pgm_cfg


def main(argv=None) -> dict:
    from causal_gen_tpu_torch import resolve_device
    from causal_gen_tpu_torch.data.datasets import setup_datasets
    from causal_gen_tpu_torch.pgm.train_pgm import preprocess_pgm_batch
    from causal_gen_tpu_torch.utils.plots import plot_cf

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pgm_path", default="")
    p.add_argument("--predictor_path", default="")
    p.add_argument("--vae_path", default="")
    p.add_argument("--converted", default="", help="a convert.save_converted file instead")
    p.add_argument("--data_dir", default="")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--do", nargs="+", required=True,
                   help="interventions, e.g. thickness=0.8 digit=3")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--particles", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="cf_panel.png")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    dscm, pgm_cfg = load_dscm(args, device)

    # the data follow the PGM's variables, with the CF trainer's
    # preprocessing (cli/train_cf.py's loader setup)
    data_cfg = dscm.cfg.replace(data_dir=args.data_dir) if args.data_dir else dscm.cfg
    if pgm_cfg.parents_x:
        data_cfg = data_cfg.replace(parents_x=tuple(pgm_cfg.parents_x))
    if "ukbb" in data_cfg.name:
        data_cfg = data_cfg.replace(context_norm="raw")
    raw = setup_datasets(data_cfg)["test"].batch(np.arange(args.n), concat_pa=False)
    obs = preprocess_pgm_batch(pgm_cfg, raw, device)

    do = {}
    for spec in args.do:
        k, v = parse_do(spec)
        if k == "digit":
            do[k] = torch.tensor(np.eye(10, dtype=np.float32)[[int(v)] * args.n], device=device)
        else:
            do[k] = torch.full((args.n, 1), v, dtype=torch.float32, device=device)

    with torch.inference_mode():
        out = dscm.forward(obs, do, cf_particles=args.particles,
                           generator=torch.Generator().manual_seed(args.seed))

    def nhwc(t):
        return t.float().cpu().numpy().transpose(0, *range(2, t.dim()), 1)

    var = out.get("var_cf_x")
    fig = plot_cf(nhwc(obs["x"]), nhwc(out["cfs"]["x"]), None if var is None else nhwc(var),
                  num_images=args.n, save_path=args.out)
    preds = {k: np.round(v.float().cpu().numpy(), 3).tolist()[:3]
             for k, v in out["cfs"].items() if k != "x"}
    print(f"{'wrote ' + args.out if fig is not None else 'no figure (matplotlib missing)'}; "
          f"counterfactual parents (first 3): {preds}")
    return out


if __name__ == "__main__":
    main()
