"""Invertible 1-D transforms for the attribute mechanisms (PyTorch).

Counterpart of ``causal_gen_tpu/pgm/transforms.py``: ``Affine``, ``Sigmoid``,
``Compose``, the linear rational spline (Dolatabadi et al. 2020, Pyro's
``Spline(order="linear")``) with its analytic inverse, and
``normalize_neg11`` and ``SoftmaxCentered``. A transform has
``forward(x) -> (y, logdet)`` and ``inverse(y) -> (x, logdet)``; the logdet is
elementwise but for ``SoftmaxCentered``'s, which is one per event (the last
dim reduced).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

# Pyro-compatible spline regularization constants
MIN_BIN_SIZE = 1e-3
MIN_DERIVATIVE = 1e-3
DEFAULT_BOUND = 3.0


class Transform:
    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def inverse(self, y: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError


@dataclass
class Affine(Transform):
    """y = loc + exp(log_scale) * x."""

    loc: "Tensor | float"
    log_scale: "Tensor | float"

    def forward(self, x):
        log_scale = torch.as_tensor(self.log_scale, dtype=x.dtype, device=x.device)
        y = self.loc + torch.exp(log_scale) * x
        return y, torch.broadcast_to(log_scale, y.shape)

    def inverse(self, y):
        log_scale = torch.as_tensor(self.log_scale, dtype=y.dtype, device=y.device)
        x = (y - self.loc) * torch.exp(-log_scale)
        return x, torch.broadcast_to(-log_scale, x.shape)


@dataclass
class Sigmoid(Transform):
    """y = sigmoid(x); logdet = -softplus(x) - softplus(-x)."""

    def forward(self, x):
        return torch.sigmoid(x), -F.softplus(x) - F.softplus(-x)

    def inverse(self, y):
        eps = torch.finfo(y.dtype).eps
        y_ = torch.clamp(y, eps, 1.0 - eps)
        x = torch.log(y_) - torch.log1p(-y_)
        return x, F.softplus(x) + F.softplus(-x)


@dataclass
class Compose(Transform):
    """Transform chain. Where a part's logdet is per event (one dim fewer,
    ``SoftmaxCentered``), the running elementwise logdet is summed over the
    event first (causal_gen_tpu/pgm/transforms.py:86-108)."""

    parts: Sequence[Transform]

    @staticmethod
    def _accumulate(ld, d):
        if ld is None:
            return d
        if d.dim() == ld.dim():
            return ld + d
        if d.dim() < ld.dim():
            return torch.sum(ld, dim=-1) + d
        return ld + torch.sum(d, dim=-1)

    def forward(self, x):
        ld = None
        for t in self.parts:
            x, d = t.forward(x)
            ld = self._accumulate(ld, d)
        return x, ld

    def inverse(self, y):
        ld = None
        for t in reversed(list(self.parts)):
            y, d = t.inverse(y)
            ld = self._accumulate(ld, d)
        return y, ld


@dataclass
class SoftmaxCentered(Transform):
    """Softmax as a bijection R^K -> the interior of the (K+1)-simplex:
    forward appends a zero pivot and softmaxes at ``temperature``; inverse
    takes log-ratios against the last coordinate
    (causal_gen_tpu/pgm/transforms.py:120-150, reference
    notebooks/discrete_mechanisms.ipynb). Its logdet is per event:
    log|det dy/dx| = 0.5 log(K+1) + sum(log y), with y floored at 1e-12."""

    temperature: float = 1.0

    def forward(self, x):
        zero = torch.zeros((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
        y = torch.softmax(torch.cat([x, zero], dim=-1) / self.temperature, dim=-1)
        ld = 0.5 * math.log(y.shape[-1]) + torch.sum(torch.log(torch.clamp(y, min=1e-12)), -1)
        return y, ld

    def inverse(self, y):
        log_y = torch.log(torch.clamp(y, min=1e-12))
        x = (log_y[..., :-1] - log_y[..., -1:]) * self.temperature
        return x, -(0.5 * math.log(y.shape[-1]) + torch.sum(log_y, dim=-1))


def normalize_neg11() -> Compose:
    """[-1,1] squashing tail of the Morpho-MNIST PGM: Sigmoid then
    Affine(loc=-1, scale=2) (reference flow_pgm.py:326-329)."""
    return Compose([Sigmoid(), Affine(loc=-1.0, log_scale=math.log(2.0))])


def _spline_bins(unnormalized: Tensor, bound: float, min_size: float) -> Tuple[Tensor, Tensor]:
    """Softmax bin sizes over [-bound, bound] with a minimum size: (sizes,
    knots) with knots[0] = -bound and knots[-1] = bound exactly."""
    k = unnormalized.shape[-1]
    sizes = (min_size + (1.0 - min_size * k) * torch.softmax(unnormalized, dim=-1)) * (2.0 * bound)
    knots = torch.cumsum(sizes, dim=-1)
    knots = torch.cat([torch.zeros_like(knots[..., :1]), knots], dim=-1) - bound
    knots = torch.cat([knots[..., :-1], torch.full_like(knots[..., -1:], bound)], dim=-1)
    return knots[..., 1:] - knots[..., :-1], knots


@dataclass
class LinearRationalSpline(Transform):
    """Elementwise monotonic linear-rational spline on [-bound, bound],
    identity outside. Parameter tensors have trailing dim K (bins) or K-1
    (interior derivatives); leading dims broadcast against the input."""

    w_un: Tensor
    h_un: Tensor
    d_un: Tensor
    l_un: Tensor
    bound: float = DEFAULT_BOUND

    def _params(self):
        widths, xk = _spline_bins(self.w_un, self.bound, MIN_BIN_SIZE)
        heights, yk = _spline_bins(self.h_un, self.bound, MIN_BIN_SIZE)
        d_in = MIN_DERIVATIVE + F.softplus(self.d_un)
        ones = torch.ones_like(d_in[..., :1])
        d = torch.cat([ones, d_in, ones], dim=-1)  # boundary derivatives = 1
        lam = 0.025 + 0.95 * torch.sigmoid(self.l_un)  # in [0.025, 0.975]
        return widths, xk, heights, yk, d, lam

    @staticmethod
    def _bin_quantities(idx, widths, xk, heights, yk, d, lam):
        def take(a, i):
            a = torch.broadcast_to(a, (*i.shape, a.shape[-1]))
            return torch.gather(a, -1, i[..., None])[..., 0]

        w, h, x0, y0 = take(widths, idx), take(heights, idx), take(xk, idx), take(yk, idx)
        dk, dk1, lm = take(d, idx), take(d, idx + 1), take(lam, idx)
        s = h / w
        wb = torch.sqrt(dk / dk1)  # weights with wa := 1
        wc = (lm * dk + (1.0 - lm) * wb * dk1) / s
        yc = ((1.0 - lm) * y0 + lm * wb * (y0 + h)) / ((1.0 - lm) + lm * wb)
        return w, h, x0, y0, lm, wb, wc, yc

    def _locate(self, v: Tensor, knots: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """(``v`` broadcast against the parameters, the mask of v inside the
        bound, v zeroed outside it, the index of v's bin among ``knots``)."""
        shape = torch.broadcast_shapes(v.shape, self.w_un.shape[:-1])
        v = torch.broadcast_to(v, shape)
        inside = (v > -self.bound) & (v < self.bound)
        vs = torch.where(inside, v, torch.zeros_like(v))
        k = knots.shape[-1] - 1
        idx = torch.clamp(torch.sum(vs[..., None] >= knots[..., :-1], dim=-1) - 1, 0, k - 1)
        return v, inside, vs, idx

    def forward(self, x):
        widths, xk, heights, yk, d, lam = self._params()
        x, inside, xs, idx = self._locate(x, xk)
        w, h, x0, y0, lm, wb, wc, yc = self._bin_quantities(idx, widths, xk, heights, yk, d, lam)
        phi = (xs - x0) / w
        den1 = (lm - phi) + wc * phi
        y1 = (y0 * (lm - phi) + wc * yc * phi) / den1
        ld1 = torch.log(lm * wc * (yc - y0)) - 2.0 * torch.log(torch.abs(den1)) - torch.log(w)
        yb = y0 + h
        den2 = wc * (1.0 - phi) + wb * (phi - lm)
        y2 = (wc * yc * (1.0 - phi) + wb * yb * (phi - lm)) / den2
        ld2 = (torch.log(wb * wc * (1.0 - lm) * (yb - yc)) - 2.0 * torch.log(torch.abs(den2))
               - torch.log(w))
        lo = phi <= lm
        y = torch.where(inside, torch.where(lo, y1, y2), x)
        ld = torch.where(inside, torch.where(lo, ld1, ld2), torch.zeros_like(x))
        return y, ld

    def inverse(self, y):
        widths, xk, heights, yk, d, lam = self._params()
        y, inside, ys, idx = self._locate(y, yk)
        w, h, x0, y0, lm, wb, wc, yc = self._bin_quantities(idx, widths, xk, heights, yk, d, lam)
        yb = y0 + h
        lo = ys <= yc
        phi1 = lm * (ys - y0) / ((ys - y0) + wc * (yc - ys))
        r = wc * (ys - yc) / (wb * (yb - ys))
        phi2 = (lm + r) / (1.0 + r)
        phi = torch.where(lo, phi1, phi2)
        x = x0 + phi * w
        # logdet of the inverse = -logdet of the forward at x
        d1 = (lm - phi) + wc * phi
        ld1 = -(torch.log(lm * wc * (yc - y0)) - 2.0 * torch.log(torch.abs(d1)) - torch.log(w))
        d2 = wc * (1.0 - phi) + wb * (phi - lm)
        ld2 = -(torch.log(wb * wc * (1.0 - lm) * (yb - yc)) - 2.0 * torch.log(torch.abs(d2))
                - torch.log(w))
        x = torch.where(inside, x, y)
        ld = torch.where(inside, torch.where(lo, ld1, ld2), torch.zeros_like(y))
        return x, ld
