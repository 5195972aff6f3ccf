"""Hierarchical VAE image mechanism (PyTorch, NCHW, unrolled decoder).

Counterpart of ``causal_gen_tpu/models/hvae.py`` (reference src/vae.py:137-523)
with the mechanism API ``forward`` (the ELBO), ``sample``, ``abduct`` and
``forward_latents``, each at an optional temperature ``t`` that scales every
prior and posterior scale (and the head's, where JAX applies it).

Every posterior draw goes through ``ops.sample_kl.fused_sample_kl`` (K1): the
CUDA kernels on the card, forward and backward, its plain version on the CPU.
The JAX model's two branches (hvae.py:429-447) compute the same math and
differ only in their random stream, so the port has the one path. Training
differentiates ``forward`` (the ELBO, with the free-bits branch) through
every block and through K1; a DMoL head's NLL goes through K3.

Random draws take ``noise``, an iterator of draws consumed in order: the
standard normals of the posterior or prior draws in block order, then, for
``sample(return_loc=False)``, the head's own (a standard normal for DGaussNet,
the uniforms (u_mix, u) for DmolNet). Else they come from a
``torch.Generator``, a CPU one on any device. Tests feed the JAX side's noise
through it.

With ``cfg.dtype == "bfloat16"`` the convs compute in bf16 and the residual
stream between blocks is bf16, with the JAX package's cast points: every
conv input (``_cat``), the per-resolution biases and the prior feature in
bf16; the prior and posterior stats, the KL, K1, the latents and the head in
float32 (causal_gen_tpu/models/hvae.py:47-56, 130, 142, 375-381, 609). The
parameters stay float32. The light blocks that K2 covers run it outside
autograd (``models/blocks.py::Block``).

Not ported, and refused by ``HVAE``: ``cond_prior``, ``q_correction`` and 3-D
volumes (later slices); the JAX ``stage_scan`` layout is a compile device and
has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from causal_gen_tpu_torch import resolve_device
from causal_gen_tpu_torch.config import Config
from causal_gen_tpu_torch.models.blocks import (
    Block,
    Encoder,
    conv_in,
    init_params,
    lecun_normal_,
    upsample_nearest,
)
from causal_gen_tpu_torch.models.likelihoods import make_likelihood
from causal_gen_tpu_torch.ops.distributions import sample_gaussian
from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl

Noise = Optional[Iterator[Tensor]]


def _bcast_pa(pa: Tensor, like: Tensor) -> Tensor:
    """(B, ctx) -> (B, ctx, H, W) at ``like``'s spatial size."""
    b, c = pa.shape
    return pa.reshape(b, c, 1, 1).expand(b, c, like.shape[2], like.shape[3])


def _next(noise: Noise) -> Optional[Tensor]:
    return None if noise is None else next(noise)


def _cat(parts: Sequence[Tensor], dtype: Optional[torch.dtype]) -> Tensor:
    """Channel concat of conv inputs in the compute dtype, each part cast
    first (causal_gen_tpu/models/hvae.py:47-56)."""
    if dtype is not None:
        parts = [p.to(dtype) for p in parts]
    return torch.cat(parts, dim=1)


def compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    """The conv compute dtype of ``cfg``: bf16, or None for float32."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


class DecoderBlock(nn.Module):
    """Top-down stochastic block (reference vae.py:137-192)."""

    def __init__(self, in_width: int, out_width: int, resolution: int, z_dim: int,
                 context_dim: int, bottleneck_factor: int, stochastic: bool,
                 version: Optional[str], n_blocks: int, posterior_scale: float = 1.0,
                 last: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.resolution = resolution
        self.z_dim = z_dim
        self.stochastic = stochastic
        bottleneck = in_width // bottleneck_factor
        k = 3 if resolution > 2 else 1
        scale = float(math.sqrt(1.0 / n_blocks))
        self.prior = Block(in_width, bottleneck, 2 * z_dim + in_width, k, residual=False,
                           version=version, last_scale=0.0,  # zero-init prior head (vae.py:308)
                           dtype=dtype)
        if stochastic:
            self.posterior = Block(2 * in_width + context_dim, bottleneck, 2 * z_dim, k,
                                   residual=False, version=version,
                                   last_scale=posterior_scale, dtype=dtype)
        self.z_proj = nn.Conv2d(z_dim + context_dim, in_width, 1)
        self.z_proj_scale = scale
        # the final block's z feeds no later prior, so flax never creates it
        self.z_feat_proj = None if last else nn.Conv2d(z_dim + in_width, out_width, 1)
        self.conv = Block(in_width, bottleneck, out_width, k, residual=True,
                          version=version, last_scale=scale, dtype=dtype)

    def init_extra_(self, generator: Optional[torch.Generator]) -> None:
        lecun_normal_(self.z_proj.weight, generator, self.z_proj_scale)

    def forward_prior(self, z: Tensor, t: Optional[float] = None
                      ) -> Tuple[Tensor, Tensor, Tensor]:
        z = self.prior(z)
        zd = self.z_dim
        stats = z[:, : 2 * zd].float()
        p_logscale = stats[:, zd:]
        if t is not None:
            p_logscale = p_logscale + math.log(t)
        return stats[:, :zd], p_logscale, z[:, 2 * zd:]

    def forward_posterior(self, z: Tensor, x: Tensor, pa: Tensor, t: Optional[float] = None
                          ) -> Tuple[Tensor, Tensor]:
        out = self.posterior(_cat([z, _bcast_pa(pa, z), x], self.dtype)).float()
        q_logscale = out[:, self.z_dim:]
        if t is not None:
            q_logscale = q_logscale + math.log(t)
        return out[:, : self.z_dim], q_logscale


def plan_decoder_blocks(cfg: Config) -> List[Tuple[int, int]]:
    """Flattened per-block (res, width) list of the decoder."""
    stages: List[Tuple[int, int]] = []
    rev_widths = tuple(reversed(cfg.model_widths))
    for i, st in enumerate(cfg.dec_stages):
        stages += [(st.res, rev_widths[i]) for _ in range(st.n_blocks)]
    return stages


class Decoder(nn.Module):
    """Top-down decoder (reference vae.py:195-319), one module per block."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        stages = plan_decoder_blocks(cfg)
        n = len(stages)
        rev_widths = tuple(reversed(cfg.model_widths))
        blocks = []
        for i, (res, width) in enumerate(stages):
            blocks.append(DecoderBlock(
                width, stages[min(n - 1, i + 1)][1], res, cfg.z_dim, cfg.context_dim,
                cfg.bottleneck, res <= cfg.z_max_res, cfg.block_version, n,
                cfg.posterior_init_scale, last=i + 1 == n, dtype=self.dtype,
            ))
            self.add_module(f"blocks_{i}", blocks[-1])
        self._blocks = blocks
        # per-resolution learned biases (reference vae.py:211-218)
        all_res = sorted(set(r for r, _ in stages))
        for i, r in enumerate(all_res):
            if r <= cfg.bias_max_res:
                self.register_parameter(
                    f"bias_{r}", nn.Parameter(torch.zeros(1, rev_widths[i], r, r)))

    def _bias_at(self, res: int) -> Optional[Tensor]:
        """The bias at ``res`` in the compute dtype, so that adding it keeps
        the residual stream in that dtype (hvae.py:375-381)."""
        b = getattr(self, f"bias_{res}", None)
        return b if b is None or self.dtype is None else b.to(self.dtype)

    def _up(self, h: Tensor, res: int) -> Tensor:
        b = self._bias_at(res)
        up = upsample_nearest(h, res)
        return up if b is None else b + up

    def forward(self, parents: Tensor, acts: Optional[Dict[int, Tensor]] = None,
                abduct: bool = False, latents: Optional[Sequence[Optional[Tensor]]] = None,
                noise: Noise = None, generator: Optional[torch.Generator] = None,
                t: Optional[float] = None) -> Tuple[Tensor, List[Dict[str, Any]]]:
        """Runs every block (reference vae.py:241-300). With ``acts`` each
        stochastic block draws z ~ q(z | z_<i, x, pa) and reports its KL
        summed over space, (B, z_dim), and with ``abduct`` also z. Without
        ``acts`` a block takes its entry of ``latents`` or draws from the prior.
        ``t`` adds log t to every prior and posterior log-scale.
        """
        bs = parents.shape[0]
        n = len(self._blocks)
        h = z = self._bias_at(1).expand(bs, -1, -1, -1)
        latents = list(latents or []) + [None] * (n - len(latents or []))
        pa = parents
        stats: List[Dict[str, Any]] = []
        for i, block in enumerate(self._blocks):
            res = block.resolution
            if h.shape[2] < res:
                h = self._up(h, res)
            # the prior depends on the previous prior latent only
            p_input = self._up(z, res) if z.shape[2] < res else z
            p_loc, p_logscale, p_feat = block.forward_prior(p_input, t)
            if block.stochastic:
                if acts is not None:
                    q_loc, q_logscale = block.forward_posterior(h, acts[res], pa, t)
                    z, kl = fused_sample_kl(
                        q_loc.contiguous(), q_logscale.contiguous(), p_loc.contiguous(),
                        p_logscale.contiguous(), eps=_next(noise), generator=generator)
                    stat: Dict[str, Any] = dict(kl=kl.sum(dim=(2, 3)))
                    if abduct:
                        stat["z"] = z
                    stats.append(stat)
                elif latents[i] is not None:
                    z = latents[i]
                else:
                    z = sample_gaussian(p_loc, p_logscale, _next(noise), generator)
            else:
                z = p_loc
            h = h + p_feat
            h = h + conv_in(block.z_proj, _cat([z, _bcast_pa(pa, z)], self.dtype), self.dtype)
            h = block.conv(h)
            if block.z_feat_proj is not None:
                # z independent of pa for the next prior (vae.py:297-300)
                z = conv_in(block.z_feat_proj, _cat([z, p_feat], self.dtype), self.dtype)
        return h, stats


class HVAE(nn.Module):
    """Conditional hierarchical VAE (reference vae.py:425-523).

    An entry point: it is built on ``device`` (CUDA unless the caller asks for
    the CPU) and initialised as flax would, from ``generator``.
    """

    def __init__(self, cfg: Config, device: "str | torch.device" = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        unsupported = [k for k, bad in (
            ("cond_prior", cfg.cond_prior), ("q_correction", cfg.q_correction),
            ("spatial_dims", cfg.spatial_dims != 2),
        ) if bad]
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"HVAE: dtype {cfg.dtype!r} is neither float32 nor bfloat16")
        if unsupported:
            raise NotImplementedError(f"HVAE port: {unsupported} not ported yet")
        self.cfg = cfg
        self.encoder = Encoder(cfg.enc_stages, cfg.model_widths, cfg.bottleneck,
                               cfg.input_channels, cfg.block_version, compute_dtype(cfg))
        self.decoder = Decoder(cfg)
        self.likelihood = make_likelihood(cfg.input_channels, cfg.model_widths[0],
                                          cfg.x_like, cfg.std_init)
        self.free_bits = cfg.kl_free_bits
        init_params(self, generator)
        self.to(resolve_device(device))

    def forward(self, x: Tensor, parents: Tensor, beta: float = 1.0, noise: Noise = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """Negative ELBO per pixel, with its NLL and KL terms."""
        acts = self.encoder(x)
        h, stats = self.decoder(parents, acts=acts, noise=noise, generator=generator)
        nll_pp = self.likelihood.nll(h.float(), x)
        if self.free_bits > 0:
            kl_pp = 0.0
            for stat in stats:
                kl_pp = kl_pp + torch.sum(
                    torch.clamp(torch.mean(stat["kl"], dim=0), min=self.free_bits))
        else:
            kl_pp = torch.zeros_like(nll_pp)
            for stat in stats:
                kl_pp = kl_pp + torch.sum(stat["kl"], dim=1)
        kl_pp = torch.mean(kl_pp / math.prod(x.shape[1:]))  # per pixel
        nll_pp = torch.mean(nll_pp)
        return dict(elbo=nll_pp + beta * kl_pp, nll=nll_pp, kl=kl_pp)

    def sample(self, parents: Tensor, return_loc: bool = True, t: Optional[float] = None,
               noise: Noise = None, generator: Optional[torch.Generator] = None,
               ) -> Tuple[Tensor, Tensor]:
        """Images from the prior (causal_gen_tpu/models/hvae.py:628-632): every stochastic
        block draws z from its prior at temperature ``t``, then the head gives
        its loc (``return_loc``) or a sample at ``t``, with the scale."""
        h, _ = self.decoder(parents, noise=noise, generator=generator, t=t)
        draw = None if return_loc else _next(noise)
        return self.likelihood.sample(h.float(), return_loc, t, draw, generator)

    def abduct(self, x: Tensor, parents: Tensor, noise: Noise = None,
               generator: Optional[torch.Generator] = None, t: Optional[float] = None,
               ) -> List[Tensor]:
        """Latents z ~ q(z | x, pa), one per stochastic block, at temperature
        ``t`` (reference vae.py:466-516 without cond_prior)."""
        acts = self.encoder(x)
        _, q_stats = self.decoder(parents, acts=acts, abduct=True, noise=noise,
                                  generator=generator, t=t)
        return [s["z"] for s in q_stats]

    def forward_latents(self, latents: Sequence[Optional[Tensor]], parents: Tensor,
                        noise: Noise = None, generator: Optional[torch.Generator] = None,
                        t: Optional[float] = None) -> Tuple[Tensor, Tensor]:
        """Decode given latents (prior draws at temperature ``t`` where one is
        None) to the likelihood's (loc, scale); the head takes ``t`` in its
        loc mode, where it does not apply it (causal_gen_tpu/models/hvae.py:667-674)."""
        h, _ = self.decoder(parents, latents=latents, noise=noise, generator=generator, t=t)
        return self.likelihood.sample(h.float(), True, t)
