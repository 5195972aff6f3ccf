"""Single-stochastic-layer conditional VAE image mechanism (PyTorch, NCHW).

Counterpart of ``causal_gen_tpu/models/simple_vae.py`` (reference
src/simple_vae.py:34-415): ``SimpleEncoder``, ``CondPrior``,
``SimpleDecoder`` and ``SimpleVAE``, with the HVAE's mechanism API
``forward`` (the ELBO), ``sample``, ``abduct`` and ``forward_latents``, so
that a ``DSCM`` takes either. It runs no custom kernel: its one latent is a
plain reparameterised draw.

The JAX model flattens an NHWC (4, 4, n) map into a dense layer and reshapes
a dense output to one; here the map is permuted to NHWC before the flatten
and from it after the reshape, so that a converted dense kernel (transposed,
``convert.py``) reads the same features in the same order.

Random draws take ``noise``, an iterator of draws consumed in order: under
``forward(train=True)`` with ``cond_prior``, first the conditioning-dropout
option (an integer tensor in {0, 1, 2}); then the latent's standard normal
(the posterior's in ``forward`` and ``abduct``, the prior's in ``sample`` and
in ``forward_latents`` without a latent); then the head's draw: the
dequantisation uniforms of ``GaussNet.nll`` in ``forward``, the head's normal
in ``sample(return_loc=False)``. Else they come from a ``torch.Generator``
(a CPU one on any device).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from causal_gen_tpu_torch import resolve_device
from causal_gen_tpu_torch.config import Config
from causal_gen_tpu_torch.models.blocks import init_params
from causal_gen_tpu_torch.models.likelihoods import GaussNet, make_likelihood
from causal_gen_tpu_torch.ops.distributions import gaussian_kl, sample_gaussian

EPS_Z = -9.0  # minimum latent logscale (reference simple_vae.py:12)
DECODER_CHANNELS = 16  # the decoder's output width (reference simple_vae.py:278)

Noise = Optional[Iterator[Tensor]]


def _next(noise: Noise) -> Optional[Tensor]:
    return None if noise is None else next(noise)


def _to_nhwc_flat(h: Tensor) -> Tensor:
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _log_t(logscale: Tensor, t: Optional[float]) -> Tensor:
    return logscale if t is None else logscale + math.log(t)


class SimpleEncoder(nn.Module):
    """q(z | x, pa) (reference simple_vae.py:34-70): three stride-2 convs
    (5x5 pad 1: 32 -> 15; 3x3 pad 1: -> 8 -> 4), two dense layers with the
    parents concatenated before the second, and the loc and log-scale heads,
    the log-scale floored at ``EPS_Z``."""

    def __init__(self, input_channels: int, context_dim: int, hidden_dim: int, z_dim: int):
        super().__init__()
        n = hidden_dim // 4
        self.Conv_0 = nn.Conv2d(input_channels, n, 5, stride=2, padding=1)
        self.Conv_1 = nn.Conv2d(n, n, 3, stride=2, padding=1)
        self.Conv_2 = nn.Conv2d(n, n, 3, stride=2, padding=1)
        self.Dense_0 = nn.Linear(n * 4 * 4, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim + context_dim, hidden_dim)
        self.Dense_2 = nn.Linear(hidden_dim, z_dim)
        self.Dense_3 = nn.Linear(hidden_dim, z_dim)

    def forward(self, x: Tensor, y: Tensor, t: Optional[float] = None) -> Tuple[Tensor, Tensor]:
        h = x
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            h = F.leaky_relu(conv(h), 0.01)
        h = F.leaky_relu(self.Dense_0(_to_nhwc_flat(h)), 0.01)
        h = F.leaky_relu(self.Dense_1(torch.cat([h, y], dim=-1)), 0.01)
        logscale = torch.clamp(self.Dense_3(h), min=EPS_Z)
        return self.Dense_2(h), _log_t(logscale, t)


class CondPrior(nn.Module):
    """p(z | pa) (reference simple_vae.py:73-100): two dense layers, the loc
    and log-scale heads (zero-initialised) and the feature ``Dense_4`` that
    the decoder reads beside z."""

    def __init__(self, context_dim: int, hidden_dim: int, z_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(context_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, hidden_dim)
        self.Dense_2 = nn.Linear(hidden_dim, z_dim)
        self.Dense_3 = nn.Linear(hidden_dim, z_dim)
        self.Dense_4 = nn.Linear(hidden_dim, z_dim)

    def init_extra_(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            for d in (self.Dense_2, self.Dense_3):
                d.weight.zero_()

    def forward(self, y: Tensor, t: Optional[float] = None) -> Tuple[Tensor, Tensor, Tensor]:
        h = F.leaky_relu(self.Dense_0(y), 0.01)
        h = F.leaky_relu(self.Dense_1(h), 0.01)
        logscale = torch.clamp(self.Dense_3(h), min=EPS_Z)
        return self.Dense_2(h), _log_t(logscale, t), self.Dense_4(h)


class SimpleDecoder(nn.Module):
    """p(x | z, pa) (reference simple_vae.py:250-321): [z (after the prior's
    feature under ``cond_prior``), pa] -> fc1 -> fc2 -> a (n, 4, 4) map, then
    three times a nearest x2 upsample, a conv and a ReLU, to 16 channels at
    32^2.

    Under ``cond_prior`` a training pass draws a conditioning-dropout option
    in {0, 1, 2} (``drop_option``; causal_gen_tpu/models/simple_vae.py:93-96)."""

    def __init__(self, cfg: Config, hidden_dim: int):
        super().__init__()
        self.cfg = cfg
        n = self.n = hidden_dim // 4
        z_in = 2 * cfg.z_dim if cfg.cond_prior else cfg.z_dim
        if cfg.cond_prior:
            self.prior = CondPrior(cfg.context_dim, hidden_dim, cfg.z_dim)
        self.fc1 = nn.Linear(z_in + cfg.context_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, n * 4 * 4)
        self.conv1 = nn.Conv2d(n, n, 3, padding=1)
        self.conv2 = nn.Conv2d(n, n, 3, padding=1)
        self.conv3 = nn.Conv2d(n, DECODER_CHANNELS, 5, padding=2)

    def drop_option(self, train: bool, noise: Noise,
                    generator: Optional[torch.Generator]) -> Optional[int]:
        """The conditioning-dropout option of a pass: None unless ``train``
        under ``cond_prior``; else taken from ``noise`` or drawn in {0, 1, 2}
        from ``generator``."""
        if not (train and self.cfg.cond_prior):
            return None
        opt = _next(noise)
        return int(torch.randint(0, 3, (), generator=generator) if opt is None else opt)

    def forward(self, y: Tensor, z: Optional[Tensor] = None, t: Optional[float] = None,
                option: Optional[int] = None, noise: Noise = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """(h, (p_loc, p_logscale)); z is drawn from the prior when None.
        ``option`` 0 zeroes ``y[:, 2:]`` in the prior's input, 1 in the
        decoder's (causal_gen_tpu/models/simple_vae.py:111-112)."""
        cfg = self.cfg

        def parents(dropped: bool) -> Tensor:
            return torch.cat([y[:, :2], y[:, 2:] * 0.0], dim=1) if dropped else y

        if cfg.cond_prior:
            p_loc, p_logscale, p_feat = self.prior(parents(option == 0), t)
        else:
            p_loc = torch.zeros((y.shape[0], cfg.z_dim), device=y.device)
            p_logscale = _log_t(torch.zeros_like(p_loc), t)
        if z is None:
            z = sample_gaussian(p_loc, p_logscale, _next(noise), generator)
        if cfg.cond_prior:
            z = torch.cat([p_feat, z], dim=-1)
        h = F.relu(self.fc1(torch.cat([z, parents(option == 1)], dim=-1)))
        h = F.relu(self.fc2(h))
        h = h.reshape(h.shape[0], 4, 4, self.n).permute(0, 3, 1, 2)
        for conv in (self.conv1, self.conv2, self.conv3):
            h = F.relu(conv(torch.repeat_interleave(torch.repeat_interleave(h, 2, 2), 2, 3)))
        return h, (p_loc, p_logscale)


class SimpleVAE(nn.Module):
    """Conditional VAE with one latent (reference simple_vae.py:324-415) and
    the mechanism API of ``HVAE``.

    An entry point: built on ``device`` (CUDA unless the caller asks for the
    CPU) and initialised as flax would, from ``generator``.
    """

    def __init__(self, cfg: Config, hidden_dim: int = 128, device: "str | torch.device" = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.spatial_dims != 2:
            raise NotImplementedError("SimpleVAE is 2-D (32^2 images) only, as in JAX")
        self.cfg = cfg
        self.cond_prior = cfg.cond_prior
        self.encoder = SimpleEncoder(cfg.input_channels, cfg.context_dim, hidden_dim, cfg.z_dim)
        self.decoder = SimpleDecoder(cfg, hidden_dim)
        self.likelihood = make_likelihood(cfg.input_channels, DECODER_CHANNELS, cfg.x_like,
                                          cfg.std_init)
        init_params(self, generator)
        self.to(resolve_device(device))

    def _nll(self, h: Tensor, x: Tensor, noise: Noise,
             generator: Optional[torch.Generator]) -> Tensor:
        if isinstance(self.likelihood, GaussNet):
            return self.likelihood.nll(h, x, _next(noise), generator)
        return self.likelihood.nll(h, x)

    def forward(self, x: Tensor, parents: Tensor, beta: float = 1.0, noise: Noise = None,
                generator: Optional[torch.Generator] = None, train: bool = True,
                mesh=None) -> Dict[str, Tensor]:
        """Negative ELBO per pixel with its NLL and KL terms; ``train``
        (default True, as in JAX) turns conditioning dropout on. ``mesh``
        (x this rank's rows) changes nothing: the terms are batch means of
        per-image terms, so the step's reduction makes the global ones."""
        q_loc, q_logscale = self.encoder(x, parents)
        option = self.decoder.drop_option(train, noise, generator)
        z = sample_gaussian(q_loc, q_logscale, _next(noise), generator)
        h, (p_loc, p_logscale) = self.decoder(parents, z, option=option)
        nll_pp = self._nll(h, x, noise, generator)
        kl = gaussian_kl(q_loc, q_logscale, p_loc, p_logscale)
        kl_pp = torch.sum(kl, dim=-1) / math.prod(x.shape[1:])
        nll = torch.mean(nll_pp)
        kl = torch.mean(kl_pp)
        return dict(elbo=nll + beta * kl, nll=nll, kl=kl)

    def sample(self, parents: Tensor, return_loc: bool = True, t: Optional[float] = None,
               noise: Noise = None, generator: Optional[torch.Generator] = None,
               ) -> Tuple[Tensor, Tensor]:
        """Images from the prior at temperature ``t``: the head's loc
        (``return_loc``) or a sample, with the scale."""
        h, _ = self.decoder(parents, t=t, noise=noise, generator=generator)
        draw = None if return_loc else _next(noise)
        return self.likelihood.sample(h, return_loc, t, draw, generator)

    def abduct(self, x: Tensor, parents: Tensor, cf_parents: Optional[Tensor] = None,
               alpha: float = 0.5, noise: Noise = None,
               generator: Optional[torch.Generator] = None, t: Optional[float] = None,
               ) -> List[Any]:
        """[z] with z ~ q(z | x, pa), detached; under ``cond_prior``
        [{z, q_loc, q_logscale}], or with ``cf_parents`` the mixture latent
        r_loc + r_scale u, u = (z - q_loc) / q_scale, r_loc = alpha q_loc +
        (1 - alpha) p_loc, r_scale = sqrt(alpha q_scale^2 + (1 - alpha)
        p_scale^2) (times ``t``), with p the prior under ``cf_parents`` at
        ``t``. The mixture weights are linear in alpha here
        (causal_gen_tpu/models/simple_vae.py:189-191), not the HVAE's alpha^2.
        ``t`` does not reach the posterior, as in JAX."""
        q_loc, q_logscale = self.encoder(x, parents)
        z = sample_gaussian(q_loc, q_logscale, _next(noise), generator)
        if not self.cond_prior:
            return [z.detach()]
        if cf_parents is None:
            return [{"z": z, "q_loc": q_loc, "q_logscale": q_logscale}]
        p_loc, p_logscale, _ = self.decoder.prior(cf_parents, t)
        q_scale = torch.exp(q_logscale)
        u = (z - q_loc) / q_scale
        r_loc = alpha * q_loc + (1 - alpha) * p_loc
        r_scale = torch.sqrt(alpha * q_scale**2 + (1 - alpha) * torch.exp(p_logscale) ** 2)
        if t is not None:
            r_scale = r_scale * t
        return [r_loc + r_scale * u]

    def forward_latents(self, latents: Sequence[Optional[Tensor]], parents: Tensor,
                        noise: Noise = None, generator: Optional[torch.Generator] = None,
                        t: Optional[float] = None, return_loc: bool = True
                        ) -> Tuple[Tensor, Tensor]:
        """Decode the latent (a prior draw at ``t`` when None) to the head's
        (loc, scale); a GaussNet head applies ``t`` in its loc mode too, as in
        JAX."""
        h, _ = self.decoder(parents, z=latents[0], t=t, noise=noise, generator=generator)
        draw = None if return_loc else _next(noise)
        return self.likelihood.sample(h, return_loc, t, draw, generator)


def build_vae(cfg: Config, device: "str | torch.device" = "cuda",
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """The image mechanism ``cfg.vae`` names: ``SimpleVAE`` for "simple",
    else ``HVAE`` (causal_gen_tpu/cli/main.py:143, cli/train_cf.py:134)."""
    if cfg.vae == "simple":
        return SimpleVAE(cfg, device=device, generator=generator)
    from causal_gen_tpu_torch.models.hvae import HVAE

    return HVAE(cfg, device=device, generator=generator)
