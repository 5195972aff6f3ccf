"""Image likelihood heads (PyTorch, NCHW).

Counterpart of ``causal_gen_tpu/models/likelihoods.py``: ``DGaussNet`` (the
discretized Gaussian of reference src/vae.py:322-423), ``GaussNet`` (the
dequantised logit-Normal of reference src/simple_vae.py:173-247), ``DmolNet``
(the mixture of logistics, reference dmol.py:218-245) and
``make_likelihood``.

The heads have the JAX surface ``nll(h, x)`` and ``sample(h, return_loc,
t)``; ``sample`` also takes its draw (a standard normal, or the DMoL
uniforms) or else a ``torch.Generator``, and ``GaussNet.nll`` its
dequantisation uniforms. The Gaussian heads take ``spatial_dims`` (1x1x1
convs over NCDHW volumes); a DMoL head is 2-D only, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from causal_gen_tpu_torch.models.blocks import lecun_normal_, make_conv
from causal_gen_tpu_torch.ops.distributions import (
    EPS_LOGSCALE,
    discretized_gaussian_nll,
    draw,
    normal_logpdf,
    sample_gaussian,
)
from causal_gen_tpu_torch.ops.dmol import mean_discretized_mix_logistic
from causal_gen_tpu_torch.ops.dmol_loss import dmol_loss
from causal_gen_tpu_torch.ops.dmol_sample import dmol_sample


class _GaussianHead(nn.Module):
    """The 1x1 loc conv and the explicit log-scale parameters of the Gaussian
    heads. ``x_logscale_kernel`` keeps flax's (width, channels) shape and
    contracts over dim 1 of an NC(D)HW map. With ``std_init > 0``, "fixed"
    freezes its kernel and bias and "shared" its kernel (vae.py:335-348):
    here they enter the graph detached."""

    def __init__(self, input_channels: int, width: int, covariance: str, std_init: float,
                 spatial_dims: int):
        super().__init__()
        self.covariance = covariance
        self.input_channels = input_channels
        self.std_init = std_init
        self.x_loc = make_conv(width, input_channels, 1, spatial_dims)
        self.x_logscale_kernel = nn.Parameter(torch.zeros(width, input_channels))
        self.x_logscale_bias = nn.Parameter(torch.zeros(input_channels))

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
        spatial = (None,) * (h.dim() - 2)
        return torch.einsum("bc...,co->bo...", h, k) + b[(None, slice(None)) + spatial]


class DGaussNet(_GaussianHead):
    """Discretized Gaussian head (reference vae.py:322-423), with the RGB
    autoregression of its channels when ``input_channels == 3``."""

    def __init__(self, input_channels: int, width: int, x_like: str = "diag_dgauss",
                 std_init: float = 0.0, spatial_dims: int = 2):
        cov = x_like.split("_")[0]
        if cov not in ("fixed", "shared", "diag"):
            raise NotImplementedError(f"{x_like} not implemented.")
        super().__init__(input_channels, width, cov, std_init, spatial_dims)
        self.channel_coeffs = (make_conv(width, 3, 1, spatial_dims) if input_channels == 3
                               else None)

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


class GaussNet(_GaussianHead):
    """Dequantised logit-Normal head (reference simple_vae.py:173-247,
    causal_gen_tpu/models/likelihoods.py:109-174): the image's logits
    logit((x255 + U) / 256), U ~ U[0, 1), under N(loc, exp(logscale)); a
    sample is sigmoid(loc [+ scale eps]) mapped back to [-1, 1]."""

    def __init__(self, input_channels: int, width: int, x_like: str = "shared_gauss",
                 std_init: float = 1.0, spatial_dims: int = 2):
        super().__init__(input_channels, width, x_like.split("_")[0], std_init, spatial_dims)

    def forward(self, h: Tensor, x: Optional[Tensor] = None,
                t: Optional[float] = None) -> Tuple[Tensor, Tensor]:
        loc = self.x_loc(h)
        logscale = torch.clamp(self._logscale(h), min=EPS_LOGSCALE)
        if t is not None:
            logscale = logscale + math.log(t)
        return loc, logscale

    def nll(self, h: Tensor, x: Tensor, u: Optional[Tensor] = None,
            generator: Optional[torch.Generator] = None) -> Tensor:
        """Per-image mean NLL of the logits of x dequantised by ``u``, the
        U[0, 1) draws of x's shape (drawn from ``generator`` when not given):
        [-1, 1] -> [0, 255], + u, / 256, logit (reference simple_vae.py:
        221-226, 237-247 with alpha = 0). A pixel at -1 with u = 0 has logit
        -inf, as in JAX."""
        loc, logscale = self(h)
        if u is None:
            u = draw(torch.rand, x.shape, generator, x.device, x.dtype)
        v = ((x + 1.0) * 127.5 + u) / 256.0
        lp = normal_logpdf(torch.log(v) - torch.log1p(-v), loc, torch.exp(logscale))
        return -torch.sum(lp, dim=tuple(range(1, x.dim()))) / math.prod(x.shape[1:])

    def sample(self, h: Tensor, return_loc: bool = True, t: Optional[float] = None,
               noise: Optional[Tensor] = None, generator: Optional[torch.Generator] = None,
               ) -> Tuple[Tensor, Tensor]:
        """(x, scale): x = clamp((256 sigmoid(loc') - 128) / 128, -1, 1) with
        loc' the loc (``return_loc``) or loc + exp(logscale) ``noise``; ``t``
        adds log t to the log-scale in both modes, as in JAX."""
        loc, logscale = self(h, t=t)
        if not return_loc:
            loc = sample_gaussian(loc, logscale, noise, generator)
        x = torch.sigmoid(loc) * 256.0
        return torch.clamp((x - 128.0) / 128.0, -1.0, 1.0), torch.exp(logscale)


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
                    std_init: float, spatial_dims: int = 2) -> nn.Module:
    kind = x_like.split("_")[1]
    if kind == "dgauss":
        return DGaussNet(input_channels, width, x_like, std_init, spatial_dims)
    if kind == "gauss":
        return GaussNet(input_channels, width, x_like, std_init, spatial_dims)
    if kind == "dmol":
        if spatial_dims != 2:  # causal_gen_tpu/models/likelihoods.py:245
            raise NotImplementedError("DMoL head is RGB-image (2-D) only")
        return DmolNet(input_channels, width)
    raise NotImplementedError(f"{x_like} not implemented.")
