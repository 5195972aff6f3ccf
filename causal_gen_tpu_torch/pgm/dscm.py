"""DSCM: the merged mechanisms and the full-image counterfactual engine
(PyTorch).

Counterpart of ``causal_gen_tpu/pgm/dscm.py`` (reference src/pgm/dscm.py):
``vae_preprocess``, ``ukbb_preprocess`` and ``DSCM.forward``, which runs
abduct -> act -> predict. The PGM's ``counterfactual`` applies its own
``discrete_variables`` rule (the MIMIC finding restore), as the JAX PGM
module does. Semantics kept from the JAX package:

- pixel-level abduction u = (x - rec_loc) / max(rec_scale, 1e-12) and
  cf_x = clamp(cf_loc + cf_scale * u, -1, 1) (dscm.py:55-56);
- multi-particle mean and Var[X] = E[X^2] - E[X]^2 map (dscm.py:58-72),
  clamped at 0 against rounding;
- Lagrangian loss = aux - (lmbda - damping * sg(eps - elbo)) * (eps - elbo)
  (dscm.py:85-88), with sg a detach.

The soft-morphometry penalty (ops/soft_morph.py) and the dense-intervention
path come with the counterfactual-training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch
from torch import Tensor

from causal_gen_tpu_torch.config import Config
from causal_gen_tpu_torch.utils.normalization import get_attr_max_min

# log-standardization constants of the UKBB training set
# (reference dscm.py:108-117; load-bearing for checkpoint compatibility)
UKBB_LOG_STANDARD = {
    "age": (4.112339973449707, 0.11769197136163712),
    "brain_volume": (13.965583801269531, 0.09537758678197861),
    "ventricle_volume": (10.345998764038086, 0.43127763271331787),
}


def ukbb_preprocess(pa: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """[-1,1] PGM parent space -> log-standard VAE parent space
    (reference dscm.py:98-118)."""
    out = dict(pa)
    for k, v in pa.items():
        if k not in ("mri_seq", "sex"):
            _max, _min = get_attr_max_min(k)
            out[k] = (v + 1) / 2 * (_max - _min) + _min
    for k, (mu, sd) in UKBB_LOG_STANDARD.items():
        if k in out:
            out[k] = (torch.log(torch.clamp(out[k], min=1e-12)) - mu) / sd
    return out


def vae_preprocess(cfg: Config, pa: Dict[str, Tensor]) -> Tensor:
    """Parents in cfg.parents_x order -> (B, context_dim) (reference
    dscm.py:121-132; the VAE broadcasts the vector at each conv)."""
    if "ukbb" in cfg.name:
        pa = ukbb_preprocess(pa)
    cols = [pa[k] if pa[k].ndim > 1 else pa[k][..., None] for k in cfg.parents_x]
    return torch.cat(cols, dim=1).to(torch.float32)


class DSCM:
    """Merged-mechanism model (reference dscm.py:16-95): a PGM over the
    attributes, the anticausal predictor and the HVAE, plus the Lagrange
    multiplier ``lmbda``. The PGM and predictor are frozen, as the reference
    freezes them (dscm.py:21-24) and the JAX package stops their gradients."""

    def __init__(self, cfg: Config, pgm, predictor, vae, elbo_constraint: float = 0.0,
                 lmbda_init: float = 0.0, damping: float = 100.0):
        self.cfg = cfg
        self.pgm = pgm.requires_grad_(False)
        self.predictor = predictor.requires_grad_(False)
        self.vae = vae
        self.elbo_constraint = elbo_constraint
        self.damping = damping
        device = next(vae.parameters()).device
        self.lmbda = torch.full((1,), lmbda_init, dtype=torch.float32, device=device)

    def forward(
        self,
        obs: Dict[str, Tensor],
        do: Dict[str, Tensor],
        cf_particles: int = 1,
        beta: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Iterable[Tensor]] = None,
        t_abduct: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Counterfactuals of ``obs`` (``x`` NC(D)HW in [-1, 1] plus the parents)
        under intervention ``do``, with the factual ELBO and the losses.
        ``t_abduct`` is the temperature of the abduction only; the decodes
        run at t = None (causal_gen_tpu/pgm/dscm.py:121,151-159).

        Random draws: ``noise`` yields the draws in order (the factual pass's
        posterior normals, then for each particle the PGM's Gumbel-Max
        posterior draws (top, rest) of each such site, if any, and the
        abduction's normals), else they come from ``generator`` (a CPU
        ``torch.Generator``).
        """
        cfg = self.cfg
        beta = cfg.beta if beta is None else beta
        noise = None if noise is None else iter(noise)
        x = obs["x"]
        pa = {k: v for k, v in obs.items() if k != "x"}
        _pa = vae_preprocess(cfg, pa)

        vae_out = self.vae(x, _pa, beta=beta, noise=noise, generator=generator, train=False)

        cf_sum = torch.zeros_like(x)
        cf_sq = torch.zeros_like(x)
        cf_pa: Dict[str, Tensor] = {}
        for _ in range(cf_particles):
            cf_pa = self.pgm.counterfactual(pa, do, generator=generator, noise=noise)
            _cf_pa = vae_preprocess(cfg, cf_pa)
            zs = self.vae.abduct(x, _pa, noise=noise, generator=generator, t=t_abduct)
            # cond_prior abduction returns {z, q_loc, q_logscale} dicts
            # (causal_gen_tpu/pgm/dscm.py:181-184); the decodes take the z
            zs = [z["z"] if isinstance(z, dict) else z for z in zs]
            cf_loc, cf_scale = self.vae.forward_latents(zs, _cf_pa, noise=noise,
                                                        generator=generator)
            rec_loc, rec_scale = self.vae.forward_latents(zs, _pa, noise=noise,
                                                          generator=generator)
            u = (x - rec_loc) / torch.clamp(rec_scale, min=1e-12)
            cf_x = torch.clamp(cf_loc + cf_scale * u, -1.0, 1.0)
            cf_sum = cf_sum + cf_x
            cf_sq = cf_sq + cf_x.detach() ** 2

        cf_x_mean = cf_sum / cf_particles
        var_cf_x = None
        if cf_particles > 1:
            # E[X^2] - E[X]^2 rounds below 0 where the particles agree; a
            # variance is not negative
            var_cf_x = ((cf_sq - cf_sum**2 / cf_particles) / cf_particles).detach().clamp(min=0.0)
        cfs = {"x": cf_x_mean, **cf_pa}

        aux_lps = self.predictor.anticausal_logprob(cfs["x"], **cf_pa)
        aux_loss = -sum(torch.sum(v) for v in aux_lps.values()) / x.shape[0]
        # Lagrangian with damping (dscm.py:85-88)
        constraint = self.elbo_constraint - vae_out["elbo"]
        loss = aux_loss - torch.sum((self.lmbda - self.damping * constraint.detach()) * constraint)

        out = dict(vae_out)
        out.update({"loss": loss, "aux_loss": aux_loss, "cfs": cfs, "var_cf_x": var_cf_x})
        return out
