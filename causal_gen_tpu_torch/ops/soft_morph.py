"""Differentiable morphometry surrogates: soft thickness and soft intensity.

Counterpart of ``causal_gen_tpu/ops/soft_morph.py``: the same operations in
the same order on (N, H, W) tensors, in plain PyTorch (no kernel: the JAX
package writes them in jnp too). The counterfactual fine-tune penalises the
distance between these estimates of a counterfactual image and its
intervened parents (``pgm/dscm.py``).

Soft thickness: bilinear x4 upsample, a sharp sigmoid at the relative 0.5
threshold, then erosion-survival counting: each 3x3 min-pool erosion peels a
pixel a side, so sum_k area(erode^k(fg)) / area(fg) grows with the stroke's
thickness; an affine calibration fitted on real images against
``eval/morphometrics.py::measure_thickness`` gives pixels.

Where the two packages must agree:
- ``F.interpolate(mode="bilinear", align_corners=False)`` is
  ``jax.image.resize(..., "linear")`` on an upsample: half-pixel centres,
  and a tap outside the image is dropped with the weights renormalised,
  which is the clamp PyTorch applies at the edges;
- the 3-tap minimum pads with +inf and nests ``torch.minimum`` as
  ``jnp.minimum`` is nested: both split the gradient evenly between tied
  inputs, and the saturated sigmoid makes ties everywhere;
- the per-image min and max of the threshold are detached, as JAX stops
  their gradients.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor


def _min3_along(x: Tensor, dim: int) -> Tensor:
    """SAME-padded 3-tap sliding minimum along ``dim`` by shifted
    ``torch.minimum`` (padding +inf)."""
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - dim)] = pad[2 * (x.dim() - 1 - dim) + 1] = 1
    xp = F.pad(x, pad, value=float("inf"))
    n = x.shape[dim]
    return torch.minimum(torch.minimum(xp.narrow(dim, 0, n), xp.narrow(dim, 1, n)),
                         xp.narrow(dim, 2, n))


def soft_erode(x: Tensor) -> Tensor:
    """3x3 min-pool of (N, H, W): the minimum over rows, then columns."""
    return _min3_along(_min3_along(x, 1), 2)


def soft_binarize(x01: Tensor, threshold: float = 0.5, temp: float = 0.02) -> Tensor:
    """Soft foreground mask of (N, H, W) in [0, 1] at the relative threshold
    min + threshold (max - min) of each image; min and max take no gradient."""
    lo = x01.amin(dim=(1, 2), keepdim=True).detach()
    hi = x01.amax(dim=(1, 2), keepdim=True).detach()
    thr = lo + (hi - lo) * threshold
    return torch.sigmoid((x01 - thr) / temp)


def soft_thickness_raw(x01: Tensor, scale: int = 4, iters: int = 12,
                       temp: float = 0.02) -> Tensor:
    """Uncalibrated per-image mean erosion-survival depth of (N, H, W)."""
    n, h, w = x01.shape
    up = F.interpolate(x01[:, None], size=(h * scale, w * scale), mode="bilinear",
                       align_corners=False)[:, 0]
    fg = soft_binarize(up, temp=temp)
    area = fg.sum(dim=(1, 2))
    e = fg
    acc = torch.zeros_like(area)
    for _ in range(iters):
        e = soft_erode(e)
        acc = acc + e.sum(dim=(1, 2))
    return acc / torch.clamp(area, min=1.0)


def soft_thickness(x01: Tensor, calib: Tuple[float, float] = (1.0, 0.0), scale: int = 4,
                   iters: int = 12, temp: float = 0.02) -> Tensor:
    """Calibrated thickness estimate a * raw + b."""
    a, b = calib
    return a * soft_thickness_raw(x01, scale=scale, iters=iters, temp=temp) + b


def soft_intensity(x255: Tensor, temp: float = 5.1) -> Tensor:
    """Foreground-weighted mean of (N, H, W) on the 0..255 scale, a
    differentiable stand-in for the median of the bright pixels
    (``eval/morphometrics.py::get_intensity``)."""
    fg = soft_binarize(x255 / 255.0, temp=temp / 255.0)
    num = (x255 * fg).sum(dim=(1, 2))
    den = torch.clamp(fg.sum(dim=(1, 2)), min=1.0)
    return num / den


def fit_calibration(raw: np.ndarray, measured: np.ndarray) -> Tuple[float, float]:
    """Least-squares affine fit measured ~ a * raw + b."""
    A = np.stack([np.asarray(raw, np.float64), np.ones_like(raw, np.float64)], 1)
    coef, *_ = np.linalg.lstsq(A, np.asarray(measured, np.float64), rcond=None)
    return float(coef[0]), float(coef[1])


def calibrate_soft_thickness(images01: np.ndarray, scale: int = 4, iters: int = 12,
                             temp: float = 0.02, device: "str | torch.device" = "cpu"
                             ) -> Tuple[Tuple[float, float], float]:
    """(a, b) fitted on real (N, H, W) images in [0, 1] against the measured
    thickness, and the fit's mean absolute error; images whose measurement
    is degenerate (0) are left out. The soft estimate runs on ``device``."""
    from causal_gen_tpu_torch.eval.morphometrics import measure_thickness

    with torch.no_grad():
        raw = soft_thickness_raw(torch.as_tensor(np.asarray(images01, np.float32), device=device),
                                 scale=scale, iters=iters, temp=temp).cpu().numpy()
    measured = measure_thickness(np.asarray(images01) * 255.0)
    keep = measured > 0
    a, b = fit_calibration(raw[keep], measured[keep])
    return (a, b), float(np.abs(a * raw[keep] + b - measured[keep]).mean())
