"""The four dataset PGMs: causal DAGs over the attributes plus the
anticausal predictors (PyTorch).

Counterparts of ``FlowPGM``, ``MorphoMNISTPGM``, ``ColourMNISTPGM`` and
``ChestPGM`` in ``causal_gen_tpu/pgm/flow_pgm.py`` (reference
src/pgm/flow_pgm.py:111-310, 313-448, 451-530, 536-710). Values: binary
(B, 1) of 0.0 / 1.0; continuous (B, 1); categorical (B, K) one-hot; the
Gumbel-Max ``finding`` (B, 1) class index.

A module holds the parameters its role uses, as the JAX package's
checkpoints do (flax creates a submodule's parameters only when it runs):
``FlowPGM`` and ``ChestPGM`` built with ``setup_predictors=False`` are the
PGM (the SCM's nets, as a ``sup_pgm`` checkpoint holds them), with
``setup_predictors=True`` the predictor (the predictors and the root
parameters, as a ``sup_aux`` checkpoint holds them), and with both
``setup_predictors`` and ``scm_nets`` the semi-supervised model (both, as a
``semi_sup`` checkpoint holds them), so that converted checkpoints load with
``strict=True``; ``MorphoMNISTPGM`` likewise (its SCM net is the
intensity flow's ``intensity_net``). ``ColourMNISTPGM`` has no SCM net.

``guide_sample`` fills the unobserved sites from the predictors q and
returns their log q, for semi-supervised training. ``noise[site]`` is a
site's draw: a uniform for a binary site (the value is u < p), a standard
normal for a continuous one (loc + scale eps), a standard Gumbel (B, K) for
a categorical one (the one-hot of argmax(logits + g), as
``jax.random.categorical`` draws); else it comes from ``generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

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
    sample_onehot_categorical,
)
from causal_gen_tpu_torch.pgm import base
from causal_gen_tpu_torch.pgm.base import Node
from causal_gen_tpu_torch.pgm.modules import CNN, MLP, DenseNN, ResNet18Head, ResNet18Trunk
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


class _Guide:
    """The sites one ``guide_sample`` call fills: each sets ``values[site]``
    from its draw (``noise[site]`` or one from ``generator``) and
    ``logq[site]``."""

    def __init__(self, obs, noise, generator, std_fixed):
        self.values: Dict[str, Tensor] = dict(obs)
        self.logq: Dict[str, Tensor] = {}
        self.noise = noise or {}
        self.generator = generator
        self.std_fixed = std_fixed

    def missing(self, site: str) -> bool:
        return self.values.get(site) is None

    def _draw(self, site, like, fn):
        if site in self.noise:
            return self.noise[site]
        return draw(fn, like.shape, self.generator, like.device)

    def binary(self, site: str, prob: Tensor) -> None:
        v = self.values[site] = (self._draw(site, prob, torch.rand) < prob).to(torch.float32)
        self.logq[site] = torch.sum(bernoulli_logpmf_probs(v, prob), -1)

    def normal(self, site: str, loc: Tensor, logs: Tensor) -> None:
        scale = _std(self.std_fixed, logs)
        v = self.values[site] = loc + scale * self._draw(site, loc, torch.randn)
        self.logq[site] = torch.sum(normal_logpdf(v, loc, scale), -1)

    def categorical(self, site: str, logits: Tensor) -> None:
        v = self.values[site] = sample_onehot_categorical(logits, generator=self.generator,
                                                          gumbel=self.noise.get(site))
        self.logq[site] = onehot_categorical_logpmf(v, logits)

    def result(self) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        return self.values, self.logq


class BasePGM(nn.Module):
    """The SCM operations over a subclass's ``_nodes()`` (reference BasePGM,
    flow_pgm.py:24-108). ``noise`` (``infer_exogeneous``,
    ``counterfactual``) yields the Gumbel-Max posteriors' draws in order (see
    ``pgm/base.py``)."""

    discrete_variables: Optional[Dict[str, str]] = None  # ChestPGM's finding restore

    def _nodes(self) -> List[Node]:
        raise NotImplementedError

    def _device(self) -> torch.device:
        return next(self.parameters()).device

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               noise: Optional[Dict[str, Tensor]] = None) -> Dict[str, Tensor]:
        """Ancestral samples of the DAG (reference flow_pgm.py:42-45)."""
        return base.ancestral_sample(self._nodes(), n, generator, self._device(), noise)

    def sample_scm(self, n: int, noise: Optional[Dict[str, Tensor]] = None,
                   do: Optional[Dict[str, Tensor]] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        return base.sample_scm(self._nodes(), n, noise=noise, do=do, generator=generator,
                               device=self._device())

    def infer_exogeneous(self, obs: Dict[str, Tensor],
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[Iterator[Tensor]] = None) -> Dict[str, Tensor]:
        return base.infer_exogeneous(self._nodes(), obs, generator, noise)

    def counterfactual(self, obs: Dict[str, Tensor], intervention: Dict[str, Tensor],
                       num_particles: int = 1, generator: Optional[torch.Generator] = None,
                       noise: Optional[Iterator[Tensor]] = None) -> Dict[str, Tensor]:
        return base.counterfactual(self._nodes(), obs, intervention,
                                   num_particles=num_particles, generator=generator,
                                   discrete_variables=self.discrete_variables, noise=noise)

    def counterfactual_dense(self, obs: Dict[str, Tensor], do_values: Dict[str, Tensor],
                             do_mask: Dict[str, Tensor], num_particles: int = 1,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[Iterator[Tensor]] = None) -> Dict[str, Tensor]:
        """The counterfactual under per-row do-masks (``base.counterfactual_dense``)."""
        return base.counterfactual_dense(self._nodes(), obs, do_values, do_mask,
                                         num_particles=num_particles, generator=generator,
                                         discrete_variables=self.discrete_variables,
                                         noise=noise)

    def svi_logprob(self, obs: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Per-site log p(obs) (reference svi_model under Trace_ELBO with the
        empty guide: the joint log-prob)."""
        return base.joint_logprob(self._nodes(), obs)

    def init_all(self, x: Optional[Tensor], obs: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The site log-probs of the SCM and, where the module has the
        predictors, of the predictors: the JAX package's init surface of a
        semi-supervised model (causal_gen_tpu/pgm/flow_pgm.py:140-146)."""
        lps = self.svi_logprob(obs)
        if x is not None and getattr(self, "setup_predictors", False):
            lps = {**lps, **self.anticausal_logprob(x, **obs)}
        return lps


class FlowPGM(BasePGM):
    """The UK Biobank brain-MRI PGM (reference flow_pgm.py:111-310). DAG: sex
    and mri_seq binary roots; age a spline flow; (sex, age) -> brain_volume
    and (brain_volume, age) -> ventricle_volume conditional affine flows.
    The predictors q(m|x), q(v|x), q(b|x,v), q(s|x,b), q(a|b,v).

    An entry point: built on ``device`` (CUDA unless the caller asks for the
    CPU) and initialised as flax would, from ``generator``; its role as the
    module docstring says."""

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
                 generator: Optional[torch.Generator] = None,
                 scm_nets: Optional[bool] = None):
        super().__init__()
        self.s_logit = nn.Parameter(torch.zeros(1, 1))
        self.m_logit = nn.Parameter(torch.zeros(1, 1))
        _spline_params(self, "age")
        self.setup_predictors = setup_predictors
        if not setup_predictors if scm_nets is None else scm_nets:
            self.bvol_net = DenseNN(2, widths, (1, 1))  # (sex, age), flow_pgm.py:148-151
            self.vvol_net = DenseNN(2, widths, (1, 1))  # (brain_volume, age), :153-157
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
        site); draws as the module docstring says."""
        q = _Guide(obs, noise, generator, self.std_fixed)
        if q.missing("mri_seq"):
            q.binary("mri_seq", torch.sigmoid(self.encoder_m(x)))
        if q.missing("ventricle_volume"):
            q.normal("ventricle_volume", *self.encoder_v(x).chunk(2, -1))
        if q.missing("brain_volume"):
            q.normal("brain_volume",
                     *self.encoder_b(x, y=q.values["ventricle_volume"]).chunk(2, -1))
        if q.missing("sex"):
            q.binary("sex", torch.sigmoid(self.encoder_s(x, y=q.values["brain_volume"])))
        if q.missing("age"):
            q.normal("age", *self.encoder_a(torch.cat(
                [q.values["brain_volume"], q.values["ventricle_volume"]], -1)).chunk(2, -1))
        return q.result()

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


class MorphoMNISTPGM(BasePGM):
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
                 generator: Optional[torch.Generator] = None,
                 scm_nets: Optional[bool] = None):
        super().__init__()
        self.digit_logits = nn.Parameter(torch.zeros(1, 10))
        _spline_params(self, "thickness")
        if not setup_predictors if scm_nets is None else scm_nets:
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

    def guide_sample(self, x: Tensor, obs: Dict[str, Optional[Tensor]],
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Dict[str, Tensor]] = None,
                     ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """q(i|x), q(t|x,i), q(y|x) in that order (reference guide,
        flow_pgm.py:384-407); (values, log q of each filled site)."""
        q = _Guide(obs, noise, generator, self.std_fixed)
        if q.missing("intensity"):
            i_loc, i_logs = self.encoder_i(x).chunk(2, -1)
            q.normal("intensity", torch.tanh(i_loc), i_logs)
        if q.missing("thickness"):
            t_loc, t_logs = self.encoder_t(x, y=q.values["intensity"]).chunk(2, -1)
            q.normal("thickness", torch.tanh(t_loc), t_logs)
        if q.missing("digit"):
            q.categorical("digit", self.encoder_y(x))
        return q.result()


class ColourMNISTPGM(BasePGM):
    """The Colour-MNIST PGM (reference flow_pgm.py:451-530): digit and colour,
    two categorical roots of 10 classes, and the predictors q(y|x), q(c|x),
    width-8 ``CNN``s on the RGB image.

    An entry point: built on ``device`` (CUDA unless the caller asks for the
    CPU) and initialised as flax would, from ``generator``. The predictors
    read RGB whatever a checkpoint's config says: the JAX CNN takes its
    input's channels, and the committed ``cmnist`` PGM configs carry the
    CLI's default ``input_channels`` of 1."""

    dag_variables = {"digit": "categorical", "colour": "categorical"}

    def __init__(self, std_fixed: float = 0.0, setup_predictors: bool = True,
                 input_res: int = 32, device: "str | torch.device" = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.digit_logits = nn.Parameter(torch.zeros(1, 10))
        self.colour_logits = nn.Parameter(torch.zeros(1, 10))
        self.setup_predictors = setup_predictors
        if setup_predictors:
            kw = dict(input_res=input_res, width=8, input_channels=3)
            self.encoder_y = CNN(num_outputs=10, **kw)
            self.encoder_c = CNN(num_outputs=10, **kw)
        self.std_fixed = std_fixed
        init_params(self, generator)
        self.to(resolve_device(device))

    def _nodes(self) -> List[Node]:
        return [
            Node("digit", base.CATEGORICAL_ROOT, logits_fn=lambda: self.digit_logits, dim=10),
            Node("colour", base.CATEGORICAL_ROOT, logits_fn=lambda: self.colour_logits, dim=10),
        ]

    def guide_sample(self, x: Tensor, obs: Dict[str, Optional[Tensor]],
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Dict[str, Tensor]] = None,
                     ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """q(y|x), then q(c|x) (reference guide, flow_pgm.py:488-502)."""
        q = _Guide(obs, noise, generator, self.std_fixed)
        for site, enc in (("digit", self.encoder_y), ("colour", self.encoder_c)):
            if q.missing(site):
                q.categorical(site, enc(x))
        return q.result()

    def predict(self, x: Tensor, **obs) -> Dict[str, Tensor]:
        return {"digit": torch.softmax(self.encoder_y(x), dim=-1),
                "colour": torch.softmax(self.encoder_c(x), dim=-1)}

    def anticausal_logprob(self, x: Tensor, **obs) -> Dict[str, Tensor]:
        return {"digit_aux": onehot_categorical_logpmf(obs["digit"], self.encoder_y(x)),
                "colour_aux": onehot_categorical_logpmf(obs["colour"], self.encoder_c(x))}


class ChestPGM(BasePGM):
    """The MIMIC-CXR chest X-ray PGM (reference flow_pgm.py:536-710). DAG: sex
    a binary root; age an 8-bin spline flow; race a categorical root (one-hot
    3); age -> finding, a Gumbel-Max mechanism whose logits come from
    ``finding_net`` (DenseNN (8, 16), sigmoid). The predictors q(s|x),
    q(r|x), q(f|x) and q(a|x, f) share a GroupNorm ResNet-18 trunk, which
    runs in float32.

    An entry point: built on ``device`` (CUDA unless the caller asks for the
    CPU) and initialised as flax would, from ``generator``; the PGM
    (``setup_predictors=False``) or the predictor (see the module
    docstring)."""

    dag_variables = {
        "race": "categorical",
        "sex": "binary",
        "finding": "binary",
        "age": "continuous",
    }
    discrete_variables = {"finding": "binary"}

    def __init__(self, std_fixed: float = 0.0, setup_predictors: bool = True,
                 input_res: int = 192, input_channels: int = 1,
                 device: "str | torch.device" = "cuda",
                 generator: Optional[torch.Generator] = None,
                 scm_nets: Optional[bool] = None):
        super().__init__()
        self.sex_logit = nn.Parameter(torch.full((1, 1), math.log(0.5)))
        self.race_logits = nn.Parameter(torch.full((1, 3), math.log(1.0 / 3.0)))
        _spline_params(self, "age", count_bins=8)
        self.setup_predictors = setup_predictors
        if not setup_predictors if scm_nets is None else scm_nets:
            # flow_pgm.py:561-566: DenseNN(1, [8, 16], [2], Sigmoid)
            self.finding_net = DenseNN(1, (8, 16), (2,), activation="sigmoid")
        if setup_predictors:
            self.trunk = ResNet18Trunk(input_channels)
            self.head_s = ResNet18Head(512, 1)
            self.head_r = ResNet18Head(512, 3)
            self.head_f = ResNet18Head(512, 1)
            self.head_a = ResNet18Head(512, 2, context_dim=1)
        self.std_fixed = std_fixed
        init_params(self, generator)
        self.to(resolve_device(device))

    def _nodes(self) -> List[Node]:
        return [
            Node("sex", base.BINARY_ROOT, logits_fn=lambda: self.sex_logit),
            Node("age", base.FLOW, transform_fn=lambda v: _spline(self, "age")),
            Node("race", base.CATEGORICAL_ROOT, logits_fn=lambda: self.race_logits, dim=3),
            Node("finding", base.GUMBEL_MAX, ("age",),
                 logits_fn=lambda v: self.finding_net(v["age"])),
        ]

    def guide_sample(self, x: Tensor, obs: Dict[str, Optional[Tensor]], train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Dict[str, Tensor]] = None,
                     ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """q(s|x), q(r|x), q(f|x), q(a|x,f) in that order, on one pass of the
        trunk (reference guide, flow_pgm.py:641-664)."""
        feats = self.trunk(x, train=train)
        q = _Guide(obs, noise, generator, self.std_fixed)
        if q.missing("sex"):
            q.binary("sex", torch.sigmoid(self.head_s(feats)))
        if q.missing("race"):
            q.categorical("race", self.head_r(feats))
        if q.missing("finding"):
            q.binary("finding", torch.sigmoid(self.head_f(feats)))
        if q.missing("age"):
            q.normal("age", *self.head_a(feats, y=q.values["finding"]).chunk(2, -1))
        return q.result()

    def predict(self, x: Tensor, train: bool = False, **obs) -> Dict[str, Tensor]:
        feats = self.trunk(x, train=train)
        return {
            "sex": torch.sigmoid(self.head_s(feats)),
            "race": torch.softmax(self.head_r(feats), dim=-1),
            "finding": torch.sigmoid(self.head_f(feats)),
            "age": self.head_a(feats, y=obs["finding"]).chunk(2, -1)[0],
        }

    def anticausal_logprob(self, x: Tensor, train: bool = False, **obs) -> Dict[str, Tensor]:
        """Per-site log q(site | x, ...) at the observed values (reference
        model_anticausal, flow_pgm.py:610-632)."""
        feats = self.trunk(x, train=train)
        a_loc, a_logs = self.head_a(feats, y=obs["finding"]).chunk(2, -1)
        return {
            "sex_aux": torch.sum(
                bernoulli_logpmf_probs(obs["sex"], torch.sigmoid(self.head_s(feats))), -1),
            "race_aux": onehot_categorical_logpmf(obs["race"], self.head_r(feats)),
            "finding_aux": torch.sum(
                bernoulli_logpmf_probs(obs["finding"], torch.sigmoid(self.head_f(feats))), -1),
            "age_aux": torch.sum(
                normal_logpdf(obs["age"], a_loc, _std(self.std_fixed, a_logs)), -1),
        }


# dataset prefix -> PGM class (causal_gen_tpu/pgm/flow_pgm.py:634-639)
PGM_REGISTRY = {"ukbb": FlowPGM, "morphomnist": MorphoMNISTPGM, "cmnist": ColourMNISTPGM,
                "mimic": ChestPGM}
