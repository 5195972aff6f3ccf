"""Distribution math for the image mechanisms and the PGM sites.

Counterpart of ``causal_gen_tpu/ops/distributions.py``; the same formulas in
the same order, in float32. The 1e-12 floors sit below bf16 resolution, so
this math stays float32 whatever the conv dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor

EPS_LOGSCALE = -9.0  # minimum logscale (reference vae.py:11)


def gaussian_kl(q_loc: Tensor, q_logscale: Tensor, p_loc: Tensor, p_logscale: Tensor) -> Tensor:
    """KL(q || p) per element for diagonal Gaussians (reference vae.py:14-25)."""
    return (
        -0.5
        + p_logscale
        - q_logscale
        + 0.5
        * (torch.exp(q_logscale) ** 2 + (q_loc - p_loc) ** 2)
        / torch.exp(p_logscale) ** 2
    )


def sample_gaussian(
    loc: Tensor,
    logscale: Tensor,
    noise: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Reparameterized Gaussian sample (reference vae.py:28-30). ``noise`` is
    the standard-normal draw; without it one is drawn from ``generator``."""
    if noise is None:
        noise = draw(torch.randn, loc.shape, generator, loc.device, loc.dtype)
    return loc + torch.exp(logscale) * noise


def draw(fn, shape, generator: Optional[torch.Generator], device: torch.device,
         dtype: torch.dtype = torch.float32) -> Tensor:
    """``fn(shape)`` (``torch.randn`` or ``torch.rand``) drawn on the
    generator's own device and moved to ``device``: the entry points take a
    CPU generator, which PyTorch refuses for a draw on the card. Without a
    generator the draw is made on ``device``."""
    on = device if generator is None else generator.device
    return fn(shape, generator=generator, dtype=dtype, device=on).to(device)


def approx_cdf(x: Tensor) -> Tensor:
    """tanh-based standard normal CDF approximation (reference vae.py:388-391)."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_nll(loc: Tensor, logscale: Tensor, x: Tensor) -> Tensor:
    """Per-image mean NLL of the 8-bit-discretized Gaussian likelihood.

    x is in [-1, 1]; bin width 2/255. Mirrors reference vae.py:393-411,
    including the +-0.999 edge branches and the 1e-12 floors; reduces with a
    mean over all non-batch axes.
    """
    centered_x = x - loc
    inv_stdv = torch.exp(-logscale)
    cdf_plus = approx_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    cdf_delta = cdf_plus - cdf_min
    log_probs = torch.where(
        x < -0.999,
        log_cdf_plus,
        torch.where(
            x > 0.999, log_one_minus_cdf_min, torch.log(torch.clamp(cdf_delta, min=1e-12))
        ),
    )
    return -1.0 * torch.mean(log_probs, dim=tuple(range(1, x.ndim)))


def log_prob_from_logits(x: Tensor, dim: int = -1) -> Tensor:
    """Numerically stable log-softmax over ``dim`` (reference dmol.py:7-11),
    written out as the JAX package writes it."""
    m = torch.amax(x, dim=dim, keepdim=True)
    return x - m - torch.log(torch.sum(torch.exp(x - m), dim=dim, keepdim=True))


_LOG_2PI = math.log(2.0 * math.pi)


def normal_logpdf(x: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    z = (x - loc) / scale
    return -0.5 * (z**2 + _LOG_2PI) - torch.log(scale)


def bernoulli_logpmf_logits(x: Tensor, logits: Tensor) -> Tensor:
    """log p(x) under Bernoulli(logits): x * l - softplus(l)."""
    return x * logits - F.softplus(logits)


def bernoulli_logpmf_probs(x: Tensor, probs: Tensor, eps: float = 1e-7) -> Tensor:
    """log p(x) under Bernoulli(probs), probs clipped to [eps, 1 - eps]."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    return x * torch.log(p) + (1.0 - x) * torch.log1p(-p)


def onehot_categorical_logpmf(x_onehot: Tensor, logits: Tensor) -> Tensor:
    """log p(one-hot x) under Categorical(logits); sums over the class axis."""
    return torch.sum(x_onehot * F.log_softmax(logits, dim=-1), dim=-1)


def sample_bernoulli(logits: Tensor, shape=None, generator: Optional[torch.Generator] = None,
                     u: Optional[Tensor] = None) -> Tensor:
    """1.0 where a uniform draw lies below sigmoid(logits), else 0.0, of
    ``shape`` (default: the logits'). ``u`` is the uniform draw; without it one
    is drawn from ``generator`` (on its own device, then moved)."""
    p = torch.sigmoid(logits)
    shape = tuple(p.shape) if shape is None else tuple(shape)
    if u is None:
        u = draw(torch.rand, shape, generator, logits.device)
    return (u < p).to(torch.float32)


def gumbel_logpdf(x: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    z = (x - loc) / scale
    return -(z + torch.exp(-z)) - torch.log(scale)


def sample_gumbel(shape, generator: Optional[torch.Generator] = None,
                  device: "str | torch.device" = "cpu", loc=0.0, scale=1.0) -> Tensor:
    """loc + scale * g, g = -log(-log u) a standard Gumbel, u uniform on
    [tiny, 1), as ``jax.random.gumbel`` draws it."""
    u = draw(torch.rand, shape, generator, torch.device(device))
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    return loc + scale * g


def sample_onehot_categorical(logits: Tensor, shape_prefix=(),
                              generator: Optional[torch.Generator] = None,
                              gumbel: Optional[Tensor] = None) -> Tensor:
    """One-hot draw from Categorical(``logits``), which broadcast against
    ``shape_prefix``: argmax(logits + g) over the classes, as
    ``jax.random.categorical`` draws, with ``gumbel`` the standard-Gumbel g
    (drawn from ``generator`` when not given)."""
    k = logits.shape[-1]
    shape = tuple(shape_prefix) + (k,) if shape_prefix else tuple(logits.shape)
    if gumbel is None:
        gumbel = sample_gumbel(shape, generator, logits.device)
    idx = torch.argmax(gumbel + logits, dim=-1)
    return F.one_hot(idx, k).to(torch.float32)
