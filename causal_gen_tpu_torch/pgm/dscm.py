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

- with ``do_mask`` the PGM step is ``counterfactual_dense``: each row takes
  its own intervention pattern in one pass (dscm.py:122-177).

- the soft-morphometry penalty (ops/soft_morph.py, dscm.py:219-242):
  ``thickness_weight`` x the mean |soft thickness of cf_x - the intervened
  thickness| and ``intensity_weight`` x the same of the intensity, in the
  attributes' own units, the targets detached; 0 unless a weight is > 0
  and the parents have the attribute (Morpho-MNIST);
- ``remat``: each HVAE pass (the factual ELBO, the abduction, both
  decodes) and the predictor's pass run under ``torch.utils.checkpoint``
  and are recomputed in the backward, as ``jax.checkpoint`` wraps them
  (dscm.py:141-210). The recompute replays the pass's draws: the injected
  ones it took from ``noise`` and the state of ``generator`` it began
  with (``models/remat.py::rematerialised``), since checkpoint restores only PyTorch's
  default generators and K1 takes its Philox seed from ``generator``.

- ``mesh`` (``parallel/mesh.py``; data parallelism): ``obs`` and ``do`` are
  this rank's rows and the Lagrangian takes the global batch-mean ELBO, a
  differentiable mean over ``data``: its coefficient λ - damping sg(ε -
  elbo) is not linear in the ELBO, so a rank's own ELBO would give another
  gradient. The HVAE takes the mesh's ``data`` axis too (its free-bits
  clamp); along ``model`` and ``space`` the ranks compute alike.

``lmbda``, the Lagrange multiplier, is a parameter that takes a gradient:
CF training ascends on it (pgm/train_cf.py). The image mechanism is an
``HVAE`` or a ``SimpleVAE``: both have the mechanism API (forward, abduct,
forward_latents).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import torch
from torch import Tensor

from causal_gen_tpu_torch.config import Config
from causal_gen_tpu_torch.models.remat import rematerialised
from causal_gen_tpu_torch.ops.soft_morph import soft_intensity, soft_thickness
from causal_gen_tpu_torch.utils.normalization import MORPHOMNIST_MIN_MAX, get_attr_max_min

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
    freezes them (dscm.py:21-24) and the JAX package stops their gradients;
    the HVAE's parameters and ``lmbda`` are what CF training updates."""

    def __init__(self, cfg: Config, pgm, predictor, vae, elbo_constraint: float = 0.0,
                 lmbda_init: float = 0.0, damping: float = 100.0,
                 thickness_weight: float = 0.0, intensity_weight: float = 0.0,
                 thickness_calib: Tuple[float, float] = (1.0, 0.0), remat: bool = False):
        self.cfg = cfg
        self.pgm = pgm.requires_grad_(False)
        self.predictor = predictor.requires_grad_(False)
        self.vae = vae
        self.elbo_constraint = elbo_constraint
        self.damping = damping
        self.thickness_weight = thickness_weight
        self.intensity_weight = intensity_weight
        self.thickness_calib = tuple(thickness_calib)
        self.remat = remat
        device = next(vae.parameters()).device
        self.lmbda = torch.nn.Parameter(
            torch.full((1,), lmbda_init, dtype=torch.float32, device=device))

    def forward(
        self,
        obs: Dict[str, Tensor],
        do: Dict[str, Tensor],
        cf_particles: int = 1,
        beta: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Iterable[Tensor]] = None,
        t_abduct: Optional[float] = None,
        do_mask: Optional[Dict[str, Tensor]] = None,
        mesh=None,
    ) -> Dict[str, Any]:
        """Counterfactuals of ``obs`` (``x`` NC(D)HW in [-1, 1] plus the parents)
        under intervention ``do``, with the factual ELBO and the losses.
        ``t_abduct`` is the temperature of the abduction only; the decodes
        run at t = None (causal_gen_tpu/pgm/dscm.py:121,151-159). With
        ``do_mask`` ({name: (B, 1) of 0/1}), ``do`` holds (B, d) values of the
        masked variables and row i is intervened on where its mask is 1
        (``counterfactual_dense``).

        Random draws: ``noise`` yields the draws in order (the factual pass's
        posterior normals, then for each particle the PGM's Gumbel-Max
        posterior draws (top, rest) of each such site, if any, and the
        abduction's normals), else they come from ``generator`` (a CPU
        ``torch.Generator``).
        """
        cfg = self.cfg
        beta = cfg.beta if beta is None else beta
        noise = None if noise is None else iter(noise)
        vae = self.vae
        x = obs["x"]
        pa = {k: v for k, v in obs.items() if k != "x"}
        _pa = vae_preprocess(cfg, pa)

        def fact_fn(x_, pa_, noise, generator):
            return vae(x_, pa_, beta=beta, noise=noise, generator=generator, train=False,
                       mesh=None if mesh is None else mesh.only("data"))

        def abduct_fn(x_, pa_, noise, generator):
            zs = vae.abduct(x_, pa_, noise=noise, generator=generator, t=t_abduct)
            # cond_prior abduction returns {z, q_loc, q_logscale} dicts
            # (causal_gen_tpu/pgm/dscm.py:181-184); the decodes take the z
            return [z["z"] if isinstance(z, dict) else z for z in zs]

        def decode_fn(zs_, pa_, noise, generator):
            return vae.forward_latents(zs_, pa_, noise=noise, generator=generator)

        def aux_fn(cf_x_, cf_pa_, noise, generator):
            return self.predictor.anticausal_logprob(cf_x_, **cf_pa_)

        def call(fn, *args):
            if self.remat:
                return rematerialised(fn, noise, generator, *args)
            return fn(*args, noise=noise, generator=generator)

        vae_out = call(fact_fn, x, _pa)
        if mesh is not None:  # the global batch's ELBO, inside autograd
            vae_out = dict(vae_out, elbo=mesh.mean(vae_out["elbo"], "data"))

        cf_sum = torch.zeros_like(x)
        cf_sq = torch.zeros_like(x)
        cf_pa: Dict[str, Tensor] = {}
        for _ in range(cf_particles):
            if do_mask is not None:
                cf_pa = self.pgm.counterfactual_dense(pa, do, do_mask, generator=generator,
                                                      noise=noise)
            else:
                cf_pa = self.pgm.counterfactual(pa, do, generator=generator, noise=noise)
            _cf_pa = vae_preprocess(cfg, cf_pa)
            zs = call(abduct_fn, x, _pa)
            cf_loc, cf_scale = call(decode_fn, zs, _cf_pa)
            rec_loc, rec_scale = call(decode_fn, zs, _pa)
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
        bs = x.shape[0]

        aux_lps = call(aux_fn, cfs["x"], cf_pa)
        aux_loss = -sum(torch.sum(v) for v in aux_lps.values()) / bs
        # Lagrangian with damping (dscm.py:85-88)
        constraint = self.elbo_constraint - vae_out["elbo"]
        loss = aux_loss - torch.sum((self.lmbda - self.damping * constraint.detach()) * constraint)

        # the soft-morphometry penalty, in the attributes' units (NCHW: channel 0)
        morph_loss = torch.zeros((), device=x.device)
        if self.thickness_weight > 0 and "thickness" in cf_pa:
            lo, hi = MORPHOMNIST_MIN_MAX["thickness"]
            tgt = (cf_pa["thickness"].reshape(bs) + 1) / 2 * (hi - lo) + lo
            est = soft_thickness((cf_x_mean[:, 0] + 1.0) / 2.0, calib=self.thickness_calib)
            morph_loss = morph_loss + self.thickness_weight * (est - tgt.detach()).abs().mean()
        if self.intensity_weight > 0 and "intensity" in cf_pa:
            lo, hi = MORPHOMNIST_MIN_MAX["intensity"]
            tgt = (cf_pa["intensity"].reshape(bs) + 1) / 2 * (hi - lo) + lo
            est = soft_intensity((cf_x_mean[:, 0] + 1.0) * 127.5)
            morph_loss = morph_loss + self.intensity_weight * (est - tgt.detach()).abs().mean()
        loss = loss + morph_loss

        out = dict(vae_out)
        out.update({"loss": loss, "aux_loss": aux_loss, "cfs": cfs, "var_cf_x": var_cf_x,
                    "morph_loss": morph_loss})
        return out
