"""The UK Biobank and Morpho-MNIST PGMs: causal DAGs over the attributes plus
the anticausal predictors (PyTorch).

Counterparts of ``FlowPGM`` and ``MorphoMNISTPGM`` in
``causal_gen_tpu/pgm/flow_pgm.py`` (reference src/pgm/flow_pgm.py:111-310,
313-448). Values: binary (B, 1) of 0.0 / 1.0; continuous (B, 1); categorical
(B, K) one-hot. The Colour-MNIST and MIMIC PGMs come with later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from causal_gen_tpu_torch import resolve_device
from causal_gen_tpu_torch.models.blocks import init_params
from causal_gen_tpu_torch.ops.distributions import (
    bernoulli_logpmf_probs,
    draw,
    normal_logpdf,
    onehot_categorical_logpmf,
)
from causal_gen_tpu_torch.pgm import base
from causal_gen_tpu_torch.pgm.base import Node
from causal_gen_tpu_torch.pgm.modules import CNN, MLP, DenseNN
from causal_gen_tpu_torch.pgm.transforms import (
    Affine,
    Compose,
    LinearRationalSpline,
    normalize_neg11,
)


def _std(std_fixed: float, x: Tensor) -> Tensor:
    """softplus scale head, or a fixed one (reference flow_pgm.py:164-168)."""
    return torch.full_like(x, std_fixed) if std_fixed > 0 else F.softplus(x)


def _spline_params(module: nn.Module, name: str, count_bins: int = 4) -> None:
    """Zero-initialised unnormalised parameters of a 1-D linear rational
    spline, ``<name>_{widths,heights,derivs,lambdas}``."""
    for suffix, k in (("widths", count_bins), ("heights", count_bins),
                      ("derivs", count_bins - 1), ("lambdas", count_bins)):
        module.register_parameter(f"{name}_{suffix}", nn.Parameter(torch.zeros(1, k)))


def _spline(module: nn.Module, name: str) -> LinearRationalSpline:
    return LinearRationalSpline(*(getattr(module, f"{name}_{s}")
                                  for s in ("widths", "heights", "derivs", "lambdas")))


class FlowPGM(nn.Module):
    """The UK Biobank brain-MRI PGM (reference flow_pgm.py:111-310). DAG: sex
    and mri_seq binary roots; age a spline flow; (sex, age) -> brain_volume
    and (brain_volume, age) -> ventricle_volume conditional affine flows.
    The predictors q(m|x), q(v|x), q(b|x,v), q(s|x,b), q(a|b,v).

    An entry point: built on ``device`` (CUDA unless the caller asks for the
    CPU) and initialised as flax would, from ``generator``."""

    dag_variables = {
        "sex": "binary",
        "mri_seq": "binary",
        "age": "continuous",
        "brain_volume": "continuous",
        "ventricle_volume": "continuous",
    }

    def __init__(self, widths: Tuple[int, ...] = (32, 32), std_fixed: float = 0.0,
                 setup_predictors: bool = True, input_res: int = 192,
                 input_channels: int = 1, device: "str | torch.device" = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.s_logit = nn.Parameter(torch.zeros(1, 1))
        self.m_logit = nn.Parameter(torch.zeros(1, 1))
        _spline_params(self, "age")
        self.bvol_net = DenseNN(2, widths, (1, 1))  # (sex, age), flow_pgm.py:148-151
        self.vvol_net = DenseNN(2, widths, (1, 1))  # (brain_volume, age), :153-157
        self.setup_predictors = setup_predictors
        if setup_predictors:
            kw = dict(input_res=input_res, input_channels=input_channels)
            self.encoder_s = CNN(num_outputs=1, context_dim=1, **kw)
            self.encoder_m = CNN(num_outputs=1, **kw)
            self.encoder_a = MLP(2, num_outputs=2)
            self.encoder_b = CNN(num_outputs=2, context_dim=1, **kw)
            self.encoder_v = CNN(num_outputs=2, **kw)
        self.std_fixed = std_fixed
        init_params(self, generator)
        self.to(resolve_device(device))

    def _nodes(self) -> List[Node]:
        def bvol_t(values):
            loc, log_scale = self.bvol_net(torch.cat([values["sex"], values["age"]], dim=-1))
            return Affine(loc=loc, log_scale=log_scale)

        def vvol_t(values):
            loc, log_scale = self.vvol_net(
                torch.cat([values["brain_volume"], values["age"]], dim=-1))
            return Affine(loc=loc, log_scale=log_scale)

        return [
            Node("sex", base.BINARY_ROOT, logits_fn=lambda: self.s_logit),
            Node("mri_seq", base.BINARY_ROOT, logits_fn=lambda: self.m_logit),
            Node("age", base.FLOW, transform_fn=lambda v: _spline(self, "age")),
            Node("brain_volume", base.FLOW, ("sex", "age"), transform_fn=bvol_t),
            Node("ventricle_volume", base.FLOW, ("brain_volume", "age"), transform_fn=vvol_t),
        ]

    def sample_scm(self, n: int, noise: Optional[Dict[str, Tensor]] = None,
                   do: Optional[Dict[str, Tensor]] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        return base.sample_scm(self._nodes(), n, noise=noise, do=do, generator=generator,
                               device=self.s_logit.device)

    def infer_exogeneous(self, obs: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return base.infer_exogeneous(self._nodes(), obs)

    def counterfactual(self, obs: Dict[str, Tensor], intervention: Dict[str, Tensor],
                       num_particles: int = 1,
                       generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        return base.counterfactual(self._nodes(), obs, intervention,
                                   num_particles=num_particles, generator=generator)

    def predict(self, x: Tensor, **obs) -> Dict[str, Tensor]:
        ctx = torch.cat([obs["brain_volume"], obs["ventricle_volume"]], dim=-1)
        return {
            "sex": torch.sigmoid(self.encoder_s(x, y=obs["brain_volume"])),
            "mri_seq": torch.sigmoid(self.encoder_m(x)),
            "age": self.encoder_a(ctx)[:, :1],
            "brain_volume": self.encoder_b(x, y=obs["ventricle_volume"])[:, :1],
            "ventricle_volume": self.encoder_v(x)[:, :1],
        }

    def guide_sample(self, x: Tensor, obs: Dict[str, Optional[Tensor]],
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Dict[str, Tensor]] = None,
                     ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """Fill the unobserved sites from q (reference guide, flow_pgm.py:207-244),
        in the order m, v, b, s, a, and return (values, log q of each filled
        site). ``noise[site]`` is that site's draw (a uniform for the binary
        sites, a standard normal for the others); else it is drawn from
        ``generator``."""
        values = dict(obs)
        logq: Dict[str, Tensor] = {}
        noise = noise or {}

        def u_of(site, like, fn):
            return noise[site] if site in noise else draw(fn, like.shape, generator, like.device)

        def binary(site, prob):
            values[site] = (u_of(site, prob, torch.rand) < prob).to(torch.float32)
            logq[site] = torch.sum(bernoulli_logpmf_probs(values[site], prob), -1)

        def normal(site, out):
            loc, logs = out.chunk(2, -1)
            scale = _std(self.std_fixed, logs)
            values[site] = loc + scale * u_of(site, loc, torch.randn)
            logq[site] = torch.sum(normal_logpdf(values[site], loc, scale), -1)

        if values.get("mri_seq") is None:
            binary("mri_seq", torch.sigmoid(self.encoder_m(x)))
        if values.get("ventricle_volume") is None:
            normal("ventricle_volume", self.encoder_v(x))
        if values.get("brain_volume") is None:
            normal("brain_volume", self.encoder_b(x, y=values["ventricle_volume"]))
        if values.get("sex") is None:
            binary("sex", torch.sigmoid(self.encoder_s(x, y=values["brain_volume"])))
        if values.get("age") is None:
            normal("age", self.encoder_a(
                torch.cat([values["brain_volume"], values["ventricle_volume"]], -1)))
        return values, logq

    def anticausal_logprob(self, x: Tensor, **obs) -> Dict[str, Tensor]:
        """Per-site log q(site | x, ...) at the observed values (reference
        model_anticausal, flow_pgm.py:246-278)."""
        def normal(site, out):
            loc, logs = out.chunk(2, -1)
            return torch.sum(normal_logpdf(obs[site], loc, _std(self.std_fixed, logs)), -1)

        ctx = torch.cat([obs["brain_volume"], obs["ventricle_volume"]], dim=-1)
        s_prob = torch.sigmoid(self.encoder_s(x, y=obs["brain_volume"]))
        m_prob = torch.sigmoid(self.encoder_m(x))
        return {
            "ventricle_volume_aux": normal("ventricle_volume", self.encoder_v(x)),
            "brain_volume_aux": normal("brain_volume",
                                       self.encoder_b(x, y=obs["ventricle_volume"])),
            "age_aux": normal("age", self.encoder_a(ctx)),
            "sex_aux": torch.sum(bernoulli_logpmf_probs(obs["sex"], s_prob), -1),
            "mri_seq_aux": torch.sum(bernoulli_logpmf_probs(obs["mri_seq"], m_prob), -1),
        }


class MorphoMNISTPGM(nn.Module):
    """An entry point: built on ``device`` (CUDA unless the caller asks for the
    CPU) and initialised as flax would, from ``generator``."""

    dag_variables = {
        "thickness": "continuous",
        "intensity": "continuous",
        "digit": "categorical",
    }

    def __init__(self, widths: Tuple[int, ...] = (32, 32), std_fixed: float = 0.0,
                 setup_predictors: bool = True, input_res: int = 32,
                 input_channels: int = 1, device: "str | torch.device" = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.digit_logits = nn.Parameter(torch.zeros(1, 10))
        _spline_params(self, "thickness")
        # thickness -> intensity conditional affine (flow_pgm.py:331-336, GELU)
        self.intensity_net = DenseNN(1, widths, (1, 1), activation="gelu")
        self.setup_predictors = setup_predictors
        if setup_predictors:
            kw = dict(input_res=input_res, width=8, input_channels=input_channels)
            self.encoder_t = CNN(num_outputs=2, context_dim=1, **kw)
            self.encoder_i = CNN(num_outputs=2, **kw)
            self.encoder_y = CNN(num_outputs=10, **kw)
        self.std_fixed = std_fixed
        init_params(self, generator)
        self.to(resolve_device(device))

    def _nodes(self) -> List[Node]:
        def thickness_t(values):
            return Compose([_spline(self, "thickness"), *normalize_neg11().parts])

        def intensity_t(values):
            loc, log_scale = self.intensity_net(values["thickness"])
            return Compose([Affine(loc=loc, log_scale=log_scale), *normalize_neg11().parts])

        return [
            Node("digit", base.CATEGORICAL_ROOT, logits_fn=lambda: self.digit_logits, dim=10),
            Node("thickness", base.FLOW, transform_fn=thickness_t),
            Node("intensity", base.FLOW, ("thickness",), transform_fn=intensity_t),
        ]

    def counterfactual(self, obs: Dict[str, Tensor], intervention: Dict[str, Tensor],
                       num_particles: int = 1,
                       generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        return base.counterfactual(self._nodes(), obs, intervention,
                                   num_particles=num_particles, generator=generator)

    def predict(self, x: Tensor, **obs) -> Dict[str, Tensor]:
        t_loc = torch.tanh(self.encoder_t(x, y=obs["intensity"]).chunk(2, -1)[0])
        i_loc = torch.tanh(self.encoder_i(x).chunk(2, -1)[0])
        y_prob = torch.softmax(self.encoder_y(x), dim=-1)
        return {"thickness": t_loc, "intensity": i_loc, "digit": y_prob}

    def anticausal_logprob(self, x: Tensor, **obs) -> Dict[str, Tensor]:
        t_loc, t_logs = self.encoder_t(x, y=obs["intensity"]).chunk(2, -1)
        i_loc, i_logs = self.encoder_i(x).chunk(2, -1)
        sd = self.std_fixed
        return {
            "thickness_aux": torch.sum(
                normal_logpdf(obs["thickness"], torch.tanh(t_loc), _std(sd, t_logs)), -1),
            "intensity_aux": torch.sum(
                normal_logpdf(obs["intensity"], torch.tanh(i_loc), _std(sd, i_logs)), -1),
            "digit_aux": onehot_categorical_logpmf(obs["digit"], self.encoder_y(x)),
        }
