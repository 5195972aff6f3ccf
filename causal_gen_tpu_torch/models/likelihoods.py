"""Image likelihood heads (PyTorch, NCHW).

Counterpart of ``causal_gen_tpu/models/likelihoods.py``: ``DGaussNet`` (the
discretized Gaussian of reference src/vae.py:322-423), ``DmolNet`` (the
mixture of logistics, reference dmol.py:218-245) and the dgauss and dmol
branches of ``make_likelihood``. The logit-Normal head comes with a later
slice.

Both heads have the JAX surface ``nll(h, x)`` and ``sample(h, return_loc,
t)``; ``sample`` also takes its draw (a standard normal, or the DMoL
uniforms) or else a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from causal_gen_tpu_torch.models.blocks import lecun_normal_
from causal_gen_tpu_torch.ops.distributions import (
    EPS_LOGSCALE,
    discretized_gaussian_nll,
    sample_gaussian,
)
from causal_gen_tpu_torch.ops.dmol import mean_discretized_mix_logistic
from causal_gen_tpu_torch.ops.dmol_loss import dmol_loss
from causal_gen_tpu_torch.ops.dmol_sample import dmol_sample


class DGaussNet(nn.Module):
    """Discretized Gaussian head (reference vae.py:322-423).

    ``x_logscale_kernel`` keeps flax's (width, channels) shape. With
    ``std_init > 0``, "fixed" freezes its kernel and bias and "shared" its
    kernel (vae.py:335-348): here they enter the graph detached.
    """

    def __init__(self, input_channels: int, width: int, x_like: str = "diag_dgauss",
                 std_init: float = 0.0):
        super().__init__()
        cov = x_like.split("_")[0]
        if cov not in ("fixed", "shared", "diag"):
            raise NotImplementedError(f"{x_like} not implemented.")
        self.covariance = cov
        self.input_channels = input_channels
        self.std_init = std_init
        self.x_loc = nn.Conv2d(width, input_channels, 1)
        self.x_logscale_kernel = nn.Parameter(torch.zeros(width, input_channels))
        self.x_logscale_bias = nn.Parameter(torch.zeros(input_channels))
        self.channel_coeffs = nn.Conv2d(width, 3, 1) if input_channels == 3 else None

    def init_extra_(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            if self.std_init > 0:
                self.x_logscale_kernel.zero_()
                self.x_logscale_bias.fill_(math.log(self.std_init))
            else:
                lecun_normal_(self.x_logscale_kernel, generator,
                              fan_in=self.x_logscale_kernel.shape[0])
                self.x_logscale_bias.zero_()

    def _logscale(self, h: Tensor) -> Tensor:
        k, b = self.x_logscale_kernel, self.x_logscale_bias
        if self.std_init > 0:
            if self.covariance == "fixed":
                k, b = k.detach(), b.detach()
            elif self.covariance == "shared":
                k = k.detach()
        return torch.einsum("bchw,co->bohw", h, k) + b[None, :, None, None]

    def forward(self, h: Tensor, x: Optional[Tensor] = None,
                t: Optional[float] = None) -> Tuple[Tensor, Tensor]:
        loc = self.x_loc(h)
        logscale = torch.clamp(self._logscale(h), min=EPS_LOGSCALE)
        if self.input_channels == 3:  # RGB autoregression (vae.py:357-381)
            coeff = torch.tanh(self.channel_coeffs(h))
            if x is None:  # inference: condition on clipped predicted subpixels
                r = torch.clamp(loc[:, 0], -1, 1)
                g = torch.clamp(loc[:, 1] + coeff[:, 0] * r, -1, 1)
                b_ = torch.clamp(loc[:, 2] + coeff[:, 1] * r + coeff[:, 2] * g, -1, 1)
            else:  # training: condition on true subpixels
                r = loc[:, 0]
                g = loc[:, 1] + coeff[:, 0] * x[:, 0]
                b_ = loc[:, 2] + coeff[:, 1] * x[:, 0] + coeff[:, 2] * x[:, 1]
            loc = torch.stack([r, g, b_], dim=1)
        if t is not None:
            logscale = logscale + math.log(t)
        return loc, logscale

    def nll(self, h: Tensor, x: Tensor) -> Tensor:
        loc, logscale = self(h, x)
        return discretized_gaussian_nll(loc, logscale, x)

    def sample(self, h: Tensor, return_loc: bool = True, t: Optional[float] = None,
               noise: Optional[Tensor] = None, generator: Optional[torch.Generator] = None,
               ) -> Tuple[Tensor, Tensor]:
        """(x, scale), x clamped to [-1, 1] (causal_gen_tpu/models/likelihoods.py:97-106).
        With ``return_loc`` x is the loc and ``t`` is not applied, as in the
        JAX head; otherwise x = loc + exp(logscale + log t) * ``noise``, the
        standard normal drawn from ``generator`` when not given."""
        if return_loc:
            x, logscale = self(h)
        else:
            loc, logscale = self(h, t=t)
            x = sample_gaussian(loc, logscale, noise, generator)
        return torch.clamp(x, -1.0, 1.0), torch.exp(logscale)


class DmolNet(nn.Module):
    """Discretized mixture-of-logistics head (reference dmol.py:218-245): a
    1x1 conv to 10K channels in the JAX package's order. ``nll`` is K3 on the
    card and the plain op on the CPU; ``sample`` with ``return_loc=False`` is
    K4 on the card and its plain version on the CPU."""

    def __init__(self, input_channels: int, width: int, num_mixtures: int = 10,
                 mask: str = "soft"):
        super().__init__()
        if input_channels != 3:
            raise NotImplementedError("DMoL head expects RGB input")
        self.num_mixtures = num_mixtures
        self.mask = mask
        self.conv = nn.Conv2d(width, num_mixtures * 10, 1)

    def forward(self, h: Tensor, x: Optional[Tensor] = None) -> Tensor:
        return self.conv(h)

    def nll(self, h: Tensor, x: Tensor) -> Tensor:
        return dmol_loss(x, self.conv(h))

    def sample(self, h: Tensor, return_loc: bool = True, t: Optional[float] = None,
               uniforms: Optional[Tuple[Tensor, Tensor]] = None,
               generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
        """(x, scale), x clamped to [-1, 1] (causal_gen_tpu/models/likelihoods.py:202-228).
        With ``return_loc`` the mean decode under ``mask``; otherwise a sample
        at temperature ``t`` (1 when None), with ``uniforms`` = (u_mix, u) the
        sampler's uniforms, drawn from ``generator`` when not given."""
        l = self.conv(h)
        if return_loc:
            x, scale = mean_discretized_mix_logistic(l, self.num_mixtures, mask=self.mask)
        else:
            u_mix, u = (None, None) if uniforms is None else uniforms
            x, scale = dmol_sample(l.contiguous(), self.num_mixtures,
                                   t=1.0 if t is None else t, u_mix=u_mix, u=u,
                                   generator=generator)
        return torch.clamp(x, -1.0, 1.0), scale


def make_likelihood(input_channels: int, width: int, x_like: str,
                    std_init: float) -> nn.Module:
    kind = x_like.split("_")[1]
    if kind == "dgauss":
        return DGaussNet(input_channels, width, x_like, std_init)
    if kind == "dmol":
        return DmolNet(input_channels, width)
    raise NotImplementedError(f"{x_like}: only the dgauss and dmol heads are ported so far")
