"""Discretized mixture-of-logistics likelihood (plain PyTorch).

Counterpart of ``causal_gen_tpu/ops/dmol.py`` (reference src/dmol.py): the
loss (``_unpack``, ``_shift_means``, ``discretized_mix_logistic_loss``), the
sampler (``_autoregress_clip``, ``sample_from_discretized_mix_logistic``) and
the mean decode (``mean_discretized_mix_logistic``), the same formulas in the
same order. The loss is the plain version of K3 (``ops/dmol_loss.py``) and
the sampler that of K4 (``ops/dmol_sample.py``); the card runs the kernels.

The public functions take NCHW tensors, as the port's heads produce them:
x (B, 3, H, W) in [-1, 1] and l (B, 10K, H, W) with the JAX package's channel
order ([:K] mixture logits, then per RGB channel c the block
K + 3K c + [means | log_scales | coeffs]). They work channels-last inside,
as the JAX functions do.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from causal_gen_tpu_torch.ops.distributions import draw, log_prob_from_logits

# the sampler's uniforms lie in [UNIFORM_LO, UNIFORM_HI) (reference dmol.py:121-161)
UNIFORM_LO = 1e-5
UNIFORM_HI = 1.0 - 1e-5


def _unpack(l: Tensor, nr_mix: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Channels-last l (B,H,W,10K) -> logits (B,H,W,K) and per-channel
    means/log_scales/coeffs, each (B,H,W,3,K)."""
    logit_probs = l[..., :nr_mix]
    rest = l[..., nr_mix:].reshape(*l.shape[:-1], 3, nr_mix * 3)
    means = rest[..., :nr_mix]
    log_scales = torch.clamp(rest[..., nr_mix: 2 * nr_mix], min=-7.0)
    coeffs = torch.tanh(rest[..., 2 * nr_mix: 3 * nr_mix])
    return logit_probs, means, log_scales, coeffs


def _shift_means(means: Tensor, coeffs: Tensor, x: Tensor) -> Tensor:
    """Condition the green and blue means on the true subpixels; x is
    (B,H,W,3,1), broadcastable to means (B,H,W,3,K)."""
    m0 = means[..., 0, :]
    m1 = means[..., 1, :] + coeffs[..., 0, :] * x[..., 0, :]
    m2 = means[..., 2, :] + coeffs[..., 1, :] * x[..., 0, :] + coeffs[..., 2, :] * x[..., 1, :]
    return torch.stack([m0, m1, m2], dim=-2)


def dmol_logprob_pixels(x: Tensor, l: Tensor, low_bit: bool = False) -> Tensor:
    """Per-pixel mixture log-prob (B, H, W) of NCHW x (B,3,H,W) under NCHW
    l (B,10K,H,W): what the TPU kernel ``_dmol_kernel`` computes."""
    nr_mix = l.shape[1] // 10
    x = x.permute(0, 2, 3, 1)
    logit_probs, means, log_scales, coeffs = _unpack(l.permute(0, 2, 3, 1), nr_mix)
    x_b = x[..., None]  # (B,H,W,3,1) against K mixtures
    means = _shift_means(means, coeffs, x_b)
    centered_x = x_b - means
    inv_stdv = torch.exp(-log_scales)
    half_bin = 1.0 / 31.0 if low_bit else 1.0 / 255.0
    plus_in = inv_stdv * (centered_x + half_bin)
    cdf_plus = torch.sigmoid(plus_in)
    min_in = inv_stdv * (centered_x - half_bin)
    cdf_min = torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)  # x == 0 edge case
    log_one_minus_cdf_min = -F.softplus(min_in)  # x == 255 edge case
    cdf_delta = cdf_plus - cdf_min
    mid_in = inv_stdv * centered_x
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    tail = math.log(15.5) if low_bit else math.log(127.5)
    log_probs = torch.where(
        x_b < -0.999,
        log_cdf_plus,
        torch.where(
            x_b > 0.999,
            log_one_minus_cdf_min,
            torch.where(
                cdf_delta > 1e-5,
                torch.log(torch.clamp(cdf_delta, min=1e-12)),
                log_pdf_mid - tail,
            ),
        ),
    )
    # sum over RGB, then mix over the components
    log_probs = torch.sum(log_probs, dim=-2) + log_prob_from_logits(logit_probs)
    return torch.logsumexp(log_probs, dim=-1)


def discretized_mix_logistic_loss(x: Tensor, l: Tensor, low_bit: bool = False) -> Tensor:
    """Per-image mean NLL (B,) of NCHW x under NCHW l (reference
    dmol.py:24-118): the -7 log-scale floor, the 1e-12 cdf floor, the 1e-5
    switch, the +-0.999 edge branches and the log 127.5 (log 15.5) tails."""
    n_dims = math.prod(x.shape[1:])
    return -1.0 * torch.sum(dmol_logprob_pixels(x, l, low_bit), dim=(1, 2)) / n_dims


def _nchw(t: Tensor) -> Tensor:
    return t.permute(0, 3, 1, 2).contiguous()


def _autoregress_clip(x: Tensor, coeffs_sel: Tensor) -> Tensor:
    """The RGB clip chain on channels-last x and coeffs (..., 3)."""
    x0 = torch.clamp(x[..., 0], -1.0, 1.0)
    x1 = torch.clamp(x[..., 1] + coeffs_sel[..., 0] * x0, -1.0, 1.0)
    x2 = torch.clamp(x[..., 2] + coeffs_sel[..., 1] * x0 + coeffs_sel[..., 2] * x1, -1.0, 1.0)
    return torch.stack([x0, x1, x2], dim=-1)


def uniforms(shape, generator: Optional[torch.Generator], device: torch.device) -> Tensor:
    """Uniforms in [UNIFORM_LO, UNIFORM_HI), lo + (hi - lo) * U[0, 1), drawn
    from ``generator`` (see ``distributions.draw``)."""
    return UNIFORM_LO + (UNIFORM_HI - UNIFORM_LO) * draw(torch.rand, shape, generator, device)


def gumbel_select(l: Tensor, u_mix: Tensor, nr_mix: int) -> Tensor:
    """The Gumbel-max pick (B, H, W) of NCHW l (B,10K,H,W) given NCHW uniforms
    u_mix (B,K,H,W): the first argmax of logit - log(-log(u))."""
    return torch.argmax(l[:, :nr_mix] - torch.log(-torch.log(u_mix)), dim=1)


def sample_from_discretized_mix_logistic(
    l: Tensor, nr_mix: int, t: Optional[float] = None, u_mix: Optional[Tensor] = None,
    u: Optional[Tensor] = None, generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Tensor]:
    """Gumbel-max mixture pick and logistic inverse-CDF sample (reference
    dmol.py:121-161): NCHW l (B,10K,H,W) -> (x, scale), each (B,3,H,W).

    The plain version of K4. ``u_mix`` (B,K,H,W) and ``u`` (B,3,H,W) are the
    uniforms, in [1e-5, 1 - 1e-5); each one not given is drawn from
    ``generator``. ``log t`` is added to the log-scale after its -7 floor.
    """
    b, _, h, w = l.shape
    if u_mix is None:
        u_mix = uniforms((b, nr_mix, h, w), generator, l.device)
    if u is None:
        u = uniforms((b, 3, h, w), generator, l.device)
    _, means_all, log_scales_all, coeffs_all = _unpack(l.permute(0, 2, 3, 1), nr_mix)
    idx = gumbel_select(l, u_mix, nr_mix)[..., None, None].expand(b, h, w, 3, 1)
    means = torch.gather(means_all, -1, idx)[..., 0]
    log_scales = torch.clamp(torch.gather(log_scales_all, -1, idx)[..., 0], min=-7.0)
    coeffs = torch.gather(coeffs_all, -1, idx)[..., 0]
    if t is not None:
        log_scales = log_scales + math.log(t)
    u = u.permute(0, 2, 3, 1)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log(1.0 - u))
    return _nchw(_autoregress_clip(x, coeffs)), _nchw(torch.exp(log_scales))


def mean_discretized_mix_logistic(l: Tensor, nr_mix: int, mask: str = "soft"
                                  ) -> Tuple[Tensor, Tensor]:
    """Deterministic decode of NCHW l (reference dmol.py:164-215) -> (x, scale),
    each (B,3,H,W), with a soft, hard or top-k (``"top3"``) mixture mask. The
    top-k mask keeps every logit >= the k-th largest, ties included."""
    logit_probs, means_all, log_scales_all, coeffs_all = _unpack(l.permute(0, 2, 3, 1), nr_mix)
    if mask == "soft":
        sel = torch.exp(log_prob_from_logits(logit_probs))[..., None, :]
    elif mask == "hard":
        amax = torch.argmax(logit_probs, dim=-1)
        sel = F.one_hot(amax, nr_mix).to(l.dtype)[..., None, :]
    elif mask.startswith("top"):
        top_k = int(mask[-1])
        if top_k >= nr_mix:
            raise ValueError("invalid top_k")
        v = torch.sort(logit_probs, dim=-1, descending=True).values
        kth = v[..., top_k - 1: top_k]
        masked = torch.where(logit_probs < kth, -math.inf, logit_probs)
        sel = torch.exp(log_prob_from_logits(masked))[..., None, :]
    else:
        raise NotImplementedError(mask)
    means = torch.sum(means_all * sel, dim=-1)
    log_scales = torch.clamp(torch.sum(log_scales_all * sel, dim=-1), min=-7.0)
    coeffs = torch.sum(coeffs_all * sel, dim=-1)
    return _nchw(_autoregress_clip(means, coeffs)), _nchw(torch.exp(log_scales))
