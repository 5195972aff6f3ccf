"""Discretized mixture-of-logistics likelihood: the loss (plain PyTorch).

Counterpart of ``causal_gen_tpu/ops/dmol.py`` (reference src/dmol.py:24-118):
``_unpack``, ``_shift_means`` and ``discretized_mix_logistic_loss``, the same
formulas in the same order. It is the plain version of K3
(``ops/dmol_loss.py``), which the card runs instead. The sampler and the mean
decode come with K4.

The public functions take NCHW tensors, as the port's heads produce them:
x (B, 3, H, W) in [-1, 1] and l (B, 10K, H, W) with the JAX package's channel
order ([:K] mixture logits, then per RGB channel c the block
K + 3K c + [means | log_scales | coeffs]). They work channels-last inside,
as the JAX functions do.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from causal_gen_tpu_torch.ops.distributions import log_prob_from_logits


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
