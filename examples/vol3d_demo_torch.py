#!/usr/bin/env python
"""Volumetric counterfactual demo with the PyTorch port: do(radius) sweeps
on the 3-D HVAE.

The twin of ``examples/vol3d_demo.py``: load a trained vol3d32 HVAE (a
checkpoint of ``causal_gen_tpu_torch/cli/main.py --hps vol3d32``), abduct
z ~ q(z | x, pa) from held-out generated volumes at temperature ``--t``,
then decode under counterfactual parents. The interventions follow the
data's mechanism: do(radius) sets intensity = 255 - 300 (radius - 0.15)
(``data/datasets.py::make_vol3d``). Renders, per volume, [observation |
reconstruction | cf at each radius] as axial (top) and sagittal (bottom)
mid-slices into a PNG (PIL).

Usage:
  python examples/vol3d_demo_torch.py --vae_path VAE/checkpoint --out vol3d_cf.png \
      [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main(argv=None) -> np.ndarray:
    from causal_gen_tpu_torch import resolve_device
    from causal_gen_tpu_torch.cli.train_cf import build_vae_from_ckpt
    from causal_gen_tpu_torch.data.datasets import VOL3D_MIN_MAX, make_vol3d
    from causal_gen_tpu_torch.train.vae_trainer import preprocess_x
    from causal_gen_tpu_torch.utils.normalization import normalize

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--vae_path", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--n", type=int, default=4, help="example volumes")
    p.add_argument("--radii", nargs="+", type=float, default=[0.18, 0.24, 0.30, 0.36])
    p.add_argument("--t", type=float, default=0.1, help="abduction temperature")
    p.add_argument("--seed", type=int, default=17)
    p.add_argument("--out", default="vol3d_cf.png")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg, model, _ = build_vae_from_ckpt(args.vae_path, device)

    # held-out volumes (the valid split's seed, data/datasets.py::vol3d)
    vols, raw = make_vol3d(args.n, cfg.input_res, seed=cfg.seed + 1)
    pa = torch.tensor(np.stack([normalize(raw[k], x_min=VOL3D_MIN_MAX[k][0],
                                          x_max=VOL3D_MIN_MAX[k][1]) for k in cfg.parents_x],
                               axis=1), dtype=torch.float32, device=device)
    x = preprocess_x(torch.from_numpy(vols).to(device).permute(0, 4, 1, 2, 3).contiguous())
    gen = torch.Generator().manual_seed(args.seed)

    def to_u8(v):  # [-1, 1] NCDHW -> uint8 NDHW
        return torch.clamp((v[:, 0] + 1.0) * 127.5, 0, 255).cpu().numpy().astype(np.uint8)

    with torch.inference_mode():
        zs = model.abduct(x, pa, t=args.t, generator=gen)
        panels = [to_u8(x), to_u8(model.forward_latents(zs, pa, t=args.t, generator=gen)[0])]
        r_lo, r_hi = VOL3D_MIN_MAX["radius"]
        i_lo, i_hi = VOL3D_MIN_MAX["intensity"]
        for r in args.radii:
            inten = float(np.clip(255.0 - 300.0 * (r - r_lo), i_lo, i_hi))
            cf_pa = torch.tensor([[normalize(np.float32(r), r_lo, r_hi),
                                   normalize(np.float32(inten), i_lo, i_hi)]] * args.n,
                                 dtype=torch.float32, device=device)
            panels.append(to_u8(model.forward_latents(zs, cf_pa, t=args.t, generator=gen)[0]))

    mid = cfg.input_res // 2
    blocks = []
    for sl in (lambda v: v[:, mid, :, :], lambda v: v[:, :, :, mid]):  # axial, sagittal
        rows = [np.concatenate([sl(p_)[i] for p_ in panels], axis=1) for i in range(args.n)]
        blocks.append(np.concatenate(rows, axis=0))
    im = np.concatenate([blocks[0], np.full((8, blocks[0].shape[1]), 64, np.uint8), blocks[1]],
                        axis=0)

    from PIL import Image

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    Image.fromarray(im).save(args.out)
    print(f"wrote {args.out}  (cols: obs | recon | do(radius)={args.radii}; "
          "top=axial, bottom=sagittal)")
    return im


if __name__ == "__main__":
    main()
