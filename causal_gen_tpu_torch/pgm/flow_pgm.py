"""The Morpho-MNIST PGM: causal DAG over (thickness, intensity, digit) plus the
anticausal predictors (PyTorch).

Counterpart of ``MorphoMNISTPGM`` in ``causal_gen_tpu/pgm/flow_pgm.py``
(reference src/pgm/flow_pgm.py:313-448). DAG: thickness -> intensity; digit
is a root. Values: continuous (B, 1) in [-1, 1]; digit (B, 10) one-hot. The
UKBB, Colour-MNIST and MIMIC PGMs come with later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from causal_gen_tpu_torch import resolve_device
from causal_gen_tpu_torch.models.blocks import init_params
from causal_gen_tpu_torch.ops.distributions import normal_logpdf, onehot_categorical_logpmf
from causal_gen_tpu_torch.pgm import base
from causal_gen_tpu_torch.pgm.base import Node
from causal_gen_tpu_torch.pgm.modules import CNN, DenseNN
from causal_gen_tpu_torch.pgm.transforms import (
    Affine,
    Compose,
    LinearRationalSpline,
    normalize_neg11,
)


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
        count_bins = 4
        for suffix, k in (("widths", count_bins), ("heights", count_bins),
                          ("derivs", count_bins - 1), ("lambdas", count_bins)):
            self.register_parameter(f"thickness_{suffix}", nn.Parameter(torch.zeros(1, k)))
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

    def _std(self, x: Tensor) -> Tensor:
        """softplus scale head, or a fixed one (reference flow_pgm.py:164-168)."""
        return torch.full_like(x, self.std_fixed) if self.std_fixed > 0 else F.softplus(x)

    def _nodes(self) -> List[Node]:
        def thickness_t(values):
            spline = LinearRationalSpline(self.thickness_widths, self.thickness_heights,
                                          self.thickness_derivs, self.thickness_lambdas)
            return Compose([spline, *normalize_neg11().parts])

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
        return {
            "thickness_aux": torch.sum(
                normal_logpdf(obs["thickness"], torch.tanh(t_loc), self._std(t_logs)), -1),
            "intensity_aux": torch.sum(
                normal_logpdf(obs["intensity"], torch.tanh(i_loc), self._std(i_logs)), -1),
            "digit_aux": onehot_categorical_logpmf(obs["digit"], self.encoder_y(x)),
        }
