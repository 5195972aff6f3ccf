"""Counterfactual effectiveness evaluation (PyTorch).

Counterpart of ``causal_gen_tpu/eval/cf_eval.py`` (reference
notebooks/eval_example.ipynb cell 9): for each test batch an intervention
do(pa_k ~ p(pa_k)) from train-set resamples, counterfactuals at the
sampling temperatures t_z = t_u = 0.1, the anticausal predictors re-run on
them and scored against the intervention's targets in the attributes'
units (``pgm/train_cf.py::cf_get_metrics``), and on Morpho-MNIST the
thickness and intensity re-measured by ``eval/morphometrics.py``; several
seeds give a mean and a standard deviation.

The host's choices (which parents, which resamples) come from numpy
generators seeded as the JAX package seeds them, so both packages pick the
same interventions; the model's draws take ``noise`` or a
``torch.Generator`` from the seed.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from causal_gen_tpu_torch.config import Config
from causal_gen_tpu_torch.eval.morphometrics import get_intensity, measure_thickness
from causal_gen_tpu_torch.pgm.dscm import vae_preprocess
from causal_gen_tpu_torch.pgm.train_cf import cf_get_metrics, dense_intervention
from causal_gen_tpu_torch.utils.metrics import mae
from causal_gen_tpu_torch.utils.normalization import MORPHOMNIST_MIN_MAX


def make_cf_generate_fn(cfg: Config, vae, pgm, predictor, t_z: float = 0.1, t_u: float = 0.1,
                        te_cf: bool = False, alpha: float = 0.65) -> Callable:
    """fn(batch, do_values, do_mask, generator=None, noise=None) -> (cfs,
    preds) under ``torch.inference_mode``, the interventions dense
    (``dense_intervention``). The abduction runs at ``t_z``, the pixel noise
    is scaled by ``t_u``; ``te_cf`` (with ``cond_prior``) decodes the
    alpha-mixture abduction's latents under the counterfactual parents (the
    total effect). Draws from ``noise`` in order: the PGM's, the
    abduction's, then the mixture abduction's."""

    @torch.inference_mode()
    def gen(batch, do_values, do_mask, generator=None, noise=None):
        noise = None if noise is None else iter(noise)
        x = batch["x"]
        pa = {k: v for k, v in batch.items() if k != "x"}
        cf_pa = pgm.counterfactual_dense(pa, do_values, do_mask, generator=generator,
                                         noise=noise)
        _pa, _cf_pa = vae_preprocess(cfg, pa), vae_preprocess(cfg, cf_pa)
        zs = vae.abduct(x, _pa, noise=noise, generator=generator, t=t_z)
        zs = [z["z"] if isinstance(z, dict) else z for z in zs]
        rec_loc, rec_scale = vae.forward_latents(zs, _pa, generator=generator)
        u = (x - rec_loc) / torch.clamp(rec_scale, min=1e-12)
        if te_cf and cfg.cond_prior:
            cf_z = vae.abduct(x, _pa, cf_parents=_cf_pa, alpha=alpha, noise=noise,
                              generator=generator)
            cf_z = [z["z"] if isinstance(z, dict) else z for z in cf_z]
            cf_loc, cf_scale = vae.forward_latents(cf_z, _cf_pa, generator=generator)
        else:
            cf_loc, cf_scale = vae.forward_latents(zs, _cf_pa, generator=generator)
        cf_x = torch.clamp(cf_loc + cf_scale * t_u * u, -1.0, 1.0)
        return {"x": cf_x, **cf_pa}, predictor.predict(cf_x, **cf_pa)

    return gen


def _np(t: Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def eval_counterfactuals(cfg: Config, vae, pgm, predictor, loader,
                         train_attrs: Dict[str, np.ndarray], device: "str | torch.device",
                         do_pa: Optional[str] = None, seed: int = 0, measure: bool = True,
                         te_cf: bool = False, alpha: float = 0.65,
                         noise: Optional[Iterable[Iterable[Tensor]]] = None
                         ) -> Dict[str, float]:
    """One sweep of ``loader`` (raw batches, ``concat_pa=False``; the parents
    in the PGM's space) at one seed: the metrics of each variable and, on
    Morpho-MNIST with ``measure``, the measured thickness and intensity
    MAEs. Each batch intervenes on ``do_pa``, or on each variable with
    probability 1/2 (at least one). ``noise`` yields each batch's draws."""
    gen = make_cf_generate_fn(cfg, vae, pgm, predictor, te_cf=te_cf, alpha=alpha)
    generator = torch.Generator().manual_seed(seed)
    host = np.random.default_rng(seed)
    dag_vars = list(pgm.dag_variables)
    noise = None if noise is None else iter(noise)
    P: Dict[str, List[np.ndarray]] = {k: [] for k in dag_vars}
    T: Dict[str, List[np.ndarray]] = {k: [] for k in dag_vars}
    cf_images: List[np.ndarray] = []
    for raw in loader:
        x = torch.from_numpy(np.asarray(raw["x"], np.float32)).to(device)
        batch = {"x": ((x - 127.5) / 127.5).permute(0, x.dim() - 1, *range(1, x.dim() - 1))
                 .contiguous(),
                 **{k: torch.from_numpy(np.asarray(v if v.ndim > 1 else v[:, None],
                                                   np.float32)).to(device)
                    for k, v in raw.items() if k != "x"}}
        bs = x.shape[0]
        # do(pa_k ~ p(pa_k)) by train-set resamples (notebook cell 9)
        keys = [do_pa] if do_pa else [k for k in dag_vars if host.random() > 0.5] or [
            dag_vars[int(host.integers(0, len(dag_vars)))]]
        do = {}
        for k in keys:
            vals = train_attrs[k]
            v = vals[host.permutation(len(vals))[:bs]]
            do[k] = torch.tensor(v if v.ndim > 1 else v[:, None], dtype=torch.float32,
                                 device=device)
        do_values, do_mask = dense_intervention(tuple(dag_vars), batch, do)
        cfs, preds = gen(batch, do_values, do_mask, generator=generator,
                         noise=None if noise is None else next(noise))
        cf_images.append(_np(cfs["x"]))
        for k in dag_vars:
            P[k].append(_np(preds[k]))
            T[k].append(_np(do[k] if k in do else cfs[k]))
    Pc = {k: np.concatenate(v) for k, v in P.items()}
    Tc = {k: np.concatenate(v) for k, v in T.items()}
    # per-variable metrics in physical units (reference train_cf.py:63-108)
    stats: Dict[str, float] = dict(cf_get_metrics(cfg.name, Pc, Tc))
    if measure and "morphomnist" in cfg.name:
        x_cf = (np.concatenate(cf_images)[:, 0] + 1.0) * 127.5  # (N, H, W)
        for k, measured in (("thickness", measure_thickness(x_cf)),
                            ("intensity", get_intensity(x_cf))):
            lo, hi = MORPHOMNIST_MIN_MAX[k]
            stats[k + "_measured_mae"] = mae((Tc[k][:, 0] + 1) / 2 * (hi - lo) + lo, measured)
    return stats


def eval_cf_loop(cfg: Config, vae, pgm, predictor, loader, train_attrs: Dict[str, np.ndarray],
                 device: "str | torch.device", seeds: Tuple[int, ...] = (0, 1, 2),
                 do_pa: Optional[str] = None, measure: bool = True, te_cf: bool = False,
                 alpha: float = 0.65) -> Dict[str, Tuple[float, float]]:
    """(mean, std) over ``seeds`` of each metric of ``eval_counterfactuals``
    (eval_example.ipynb cell 9)."""
    runs = [eval_counterfactuals(cfg, vae, pgm, predictor, loader, train_attrs, device,
                                 do_pa=do_pa, seed=s, measure=measure, te_cf=te_cf, alpha=alpha)
            for s in seeds]
    return {k: (float(np.mean([r[k] for r in runs])), float(np.std([r[k] for r in runs])))
            for k in runs[0]}
