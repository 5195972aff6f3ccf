"""Training-time visualisation grid of the port.

Counterpart of ``causal_gen_tpu/utils/viz.py`` (reference src/utils.py:
231-419, ``write_images``): the original batch, its reconstructions from the
abducted latents, samples at ten temperatures, and for each sample a row of
single-attribute pseudo-counterfactuals (``make_cf_parents``) with its
difference from the reconstruction; under ``cond_prior`` also the indirect
and total effects of the mixture abduction. The rows are tiled into one
uint8 image, saved as a PNG when a path is given (PIL, imported there).

Each row group is one batched call of the model, under
``torch.inference_mode()``: on the card the posterior draws go through K1
and the light blocks of ukbb192 through K2. The draws come from ``noise``,
an iterator consumed in the JAX function's order (the abduction's posterior
normals; per cut level the reconstruction's prior normals for the blocks
past the cut; per temperature the sample's prior normals; per cut level the
tiled reconstruction's and direct effect's, then under ``cond_prior`` the
mixture abduction's posterior and prior normals), or from ``generator`` (a
CPU generator, seed 0 by default, as JAX's default key is 0).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch import Tensor

from causal_gen_tpu_torch.config import Config

TEMPS = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]


def _postprocess(x: Tensor) -> np.ndarray:
    """[-1, 1] NC(D)HW -> uint8 [0, 255] NHWC on the host. 3-D volumes are
    rendered as their middle-depth slice."""
    arr = x.detach().float().cpu().numpy()
    arr = arr.transpose(0, *range(2, arr.ndim), 1)
    if arr.ndim == 5:
        arr = arr[:, arr.shape[1] // 2]
    return ((arr + 1.0) * 127.5).astype(np.uint8)


def make_cf_parents(cfg: Config, pa: np.ndarray, shuffled_pa: np.ndarray) -> np.ndarray:
    """Per-attribute intervention rows for one sample
    (reference utils.py:339-371). pa: (ctx,), shuffled_pa: (ctx,) from a
    random other sample. Returns (context_dim, ctx)."""
    d = cfg.context_dim
    cf_pa = np.tile(pa[None], (d, 1)).astype(np.float32)
    if "ukbb" in cfg.name:
        cf_pa[0, 0] = 1 - cf_pa[0, 0]  # invert mri_seq
        cf_pa[1, 1] = shuffled_pa[1]  # random brain volume
        cf_pa[2, 2] = shuffled_pa[2]  # random ventricle volume
        if d == 4:
            cf_pa[3, 3] = 1 - cf_pa[3, 3]  # invert sex
    elif "morphomnist" in cfg.name:
        assert d == 12
        cf_pa[0, 0] = shuffled_pa[0]  # random thickness
        cf_pa[1, 1] = shuffled_pa[1]  # random intensity
        cf_pa[2:, 2:] = np.eye(10)  # each digit
    elif "cmnist" in cfg.name:
        assert d == 20
        cf_pa[:10, :10] = np.eye(10)  # each digit
        cf_pa[10:, 10:] = np.eye(10)  # each colour
    elif "vol3d" in cfg.name:
        cf_pa[0, 0] = shuffled_pa[0]  # random radius
        cf_pa[1, 1] = shuffled_pa[1]  # random intensity
    else:
        raise NotImplementedError(cfg.name)
    return cf_pa


def _tile(zs: List[Tensor], reps: int) -> List[Tensor]:
    """Each latent row repeated ``reps`` times (sample-major order)."""
    return [z.repeat_interleave(reps, dim=0) for z in zs]


@torch.inference_mode()
def write_images(cfg: Config, model, batch: Dict[str, np.ndarray], save_path: Optional[str],
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Iterator[Tensor]] = None, alpha: float = 0.6, t: float = 0.5,
                 n_latents_viz: int = 0) -> np.ndarray:
    """Build (and save, with ``save_path``) the grid of ``model`` (an HVAE,
    e.g. the EMA) on ``batch`` ({"x": N(D)HWC uint8 or [-1, 1], "pa"});
    returns the uint8 image, (rows * H, bs * W, C).

    ``n_latents_viz`` > 0 adds the partial-abduction sweep: reconstructions
    and counterfactual panels from only the first ``l`` abducted latents at
    each of the ``l_points`` cut levels (the rest drawn from the prior);
    0 keeps the full abduction only."""
    device = next(model.parameters()).device
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    kw = dict(noise=noise, generator=generator)
    x_np = np.asarray(batch["x"], np.float32)
    if float(np.max(np.abs(x_np))) > 1.5:
        x_np = (x_np - 127.5) / 127.5
    x = torch.from_numpy(x_np.transpose(0, x_np.ndim - 1, *range(1, x_np.ndim - 1))
                         .copy()).to(device)
    pa_np = np.asarray(batch["pa"], np.float32)
    pa = torch.from_numpy(pa_np).to(device)
    bs, c = x_np.shape[0], x_np.shape[-1]
    h, w = x_np.shape[-3], x_np.shape[-2]  # display dims (3-D: mid-depth slice)

    def fwd(zs, pa_, t_):
        return model.forward_latents(zs, pa_, t=t_, **kw)[0]

    orig = _postprocess(x)
    rows: List[np.ndarray] = [orig]

    # reconstructions from the first l abducted latents at each cut level
    # (utils.py:289-305); n_latents_viz=0 -> l_points=[len(zs)]
    zs = model.abduct(x, pa, **kw)
    z_plain = [z["z"] if isinstance(z, dict) else z for z in zs]
    l_points = np.floor(np.linspace(0, 1, n_latents_viz + 2) * len(zs)).astype(int)[1:]
    for l in l_points:
        rows.append(_postprocess(fwd(z_plain[: int(l)], pa, 0.1)))
    rows.append(np.zeros_like(orig))

    # samples at ten temperatures (utils.py:307-311)
    for temp in TEMPS:
        rows.append(_postprocess(model.sample(pa, True, t=temp, **kw)[0]))
    rows.append(np.zeros_like(orig))

    # pseudo-counterfactual panel: per sample, each attribute intervened on
    # with the same abducted z (utils.py:313-404); all samples' rows batched
    host_rng = np.random.RandomState(1)
    idx = np.arange(bs)
    host_rng.shuffle(idx)
    d = cfg.context_dim
    pad = np.zeros((max(0, bs - d), h, w, c), np.uint8)

    def _row(img: np.ndarray) -> np.ndarray:
        return np.concatenate([img[:bs], pad], axis=0) if d < bs else img[:bs]

    cf_pa_all = np.stack([make_cf_parents(cfg, pa_np[i], pa_np[idx[i]]) for i in range(bs)])
    cf_pa_flat = torch.from_numpy(cf_pa_all.reshape(bs * d, -1)).to(device)
    pa_rep_flat = torch.from_numpy(np.repeat(pa_np, d, axis=0)).to(device)

    def _grid(loc: Tensor) -> np.ndarray:
        return _postprocess(loc).reshape(bs, d, h, w, c)

    for l in l_points:
        zl = _tile(z_plain[: int(l)], d)
        rec = _grid(fwd(zl, pa_rep_flat, t)).astype(np.int16)
        de = _grid(fwd(zl, cf_pa_flat, t))  # direct effect: x* = g(pa*, z)
        effects = []
        if cfg.cond_prior:
            # the mixture latents stay full length (the reference cuts only
            # the direct effect's z at l, utils.py:274 vs 395-398): indirect
            # effect x* = g(pa, z*), then total x* = g(pa*, z*)
            cf_z = model.abduct(x.repeat_interleave(d, dim=0), pa_rep_flat,
                                cf_parents=cf_pa_flat, alpha=alpha, t=t, **kw)
            for pa_fwd in (pa_rep_flat, cf_pa_flat):
                effects.append(_grid(fwd(cf_z, pa_fwd, t)))
        for i in range(bs):
            rows.append(_row(de[i]))
            rows.append(_row((de[i].astype(np.int16) - rec[i]).astype(np.uint8)))
            for eff in effects:
                rows.append(_row(eff[i]))
                rows.append(_row((eff[i].astype(np.int16) - rec[i]).astype(np.uint8)))
        rows.append(np.zeros_like(orig))

    # tile the rows into one image (utils.py:405-419)
    rows = [r if r.shape[0] == bs else np.concatenate(
        [r, np.zeros((bs - r.shape[0], h, w, c), np.uint8)], axis=0) for r in rows]
    n_rows = len(rows)
    im = (np.concatenate(rows, axis=0).reshape((n_rows, bs, h, w, c))
          .transpose([0, 2, 1, 3, 4]).reshape([n_rows * h, bs * w, c]))
    if save_path:
        from PIL import Image

        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        Image.fromarray(im[..., 0] if c == 1 else im).save(save_path)
    return im
