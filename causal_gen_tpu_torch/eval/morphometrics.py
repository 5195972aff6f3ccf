"""Morpho-MNIST morphometric measurement (thickness, intensity), numpy + scipy.

The port's own copy of ``causal_gen_tpu/eval/morphometrics.py`` (the same
code: that module imports no JAX, but the port imports nothing of the JAX
package). It is the measured protocol of the reference's evaluation
(notebooks/eval_example.ipynb cell 9, after the Morpho-MNIST tools'
ImageMorphology.mean_thickness): upscale x4, binarize at the relative 0.5
threshold, thin to a skeleton by Zhang-Suen, then thickness = 2 x the mean
Euclidean distance transform over the skeleton / scale. Intensity is the
median of the pixels above min + 0.5 (max - min).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def get_intensity(x: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Median intensity of bright pixels per image.

    x: (N, H, W) float array (any range). Mirrors eval_example.ipynb cell 9.
    """
    x = np.asarray(x, np.float64)
    x_min = x.min(axis=(1, 2), keepdims=True)
    x_max = x.max(axis=(1, 2), keepdims=True)
    mask = x >= x_min + (x_max - x_min) * threshold
    out = np.empty(x.shape[0])
    for i in range(x.shape[0]):
        vals = x[i][mask[i]]
        out[i] = np.median(vals) if vals.size else 0.0
    return out


def _zhang_suen_thin(img: np.ndarray, max_iter: int = 200) -> np.ndarray:
    """Zhang-Suen binary thinning -> 1-pixel skeleton (numpy, vectorized)."""
    img = img.astype(bool).copy()

    def neighbors(a):
        # p2..p9 clockwise starting north
        return [
            np.roll(a, 1, 0),                      # p2 N
            np.roll(np.roll(a, 1, 0), -1, 1),      # p3 NE
            np.roll(a, -1, 1),                     # p4 E
            np.roll(np.roll(a, -1, 0), -1, 1),     # p5 SE
            np.roll(a, -1, 0),                     # p6 S
            np.roll(np.roll(a, -1, 0), 1, 1),      # p7 SW
            np.roll(a, 1, 1),                      # p8 W
            np.roll(np.roll(a, 1, 0), 1, 1),       # p9 NW
        ]

    for _ in range(max_iter):
        changed = False
        for phase in (0, 1):
            p = neighbors(img)
            b = sum(x.astype(np.int8) for x in p)
            seq = p + [p[0]]
            a = sum(
                ((~seq[i]) & seq[i + 1]).astype(np.int8) for i in range(8)
            )
            if phase == 0:
                c1 = ~(p[0] & p[2] & p[4])
                c2 = ~(p[2] & p[4] & p[6])
            else:
                c1 = ~(p[0] & p[2] & p[6])
                c2 = ~(p[0] & p[4] & p[6])
            cond = img & (b >= 2) & (b <= 6) & (a == 1) & c1 & c2
            if cond.any():
                img &= ~cond
                changed = True
        if not changed:
            break
    return img


def measure_thickness(
    x: np.ndarray, threshold: float = 0.5, scale: int = 4
) -> np.ndarray:
    """Mean stroke thickness per image (ImageMorphology.mean_thickness).

    x: (N, H, W) float array. Upscale by ``scale``, binarize at the relative
    threshold, skeletonize, and average 2*EDT over the skeleton / scale.
    """
    x = np.asarray(x, np.float64)
    out = np.empty(x.shape[0])
    for i in range(x.shape[0]):
        img = x[i]
        hi = ndimage.zoom(img, scale, order=1)
        lo, hi_v = hi.min(), hi.max()
        binary = hi >= lo + (hi_v - lo) * threshold
        if not binary.any():
            out[i] = 0.0
            continue
        skel = _zhang_suen_thin(binary)
        if not skel.any():
            out[i] = 0.0
            continue
        dist = ndimage.distance_transform_edt(binary)
        out[i] = 2.0 * float(dist[skel].mean()) / scale
    return out
