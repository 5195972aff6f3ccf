"""Attribute normalization: a copy of the parts of
``causal_gen_tpu/utils/normalization.py`` that the port reads.

These constants are load-bearing for checkpoint compatibility across the
mechanisms and must not drift from the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# UKBB attribute (max, min) stats (reference datasets.py:89-98)
UKBB_ATTR_MAX_MIN = {
    "age": (73.0, 44.0),
    "brain_volume": (1629520.0, 841919.0),
    "ventricle_volume": (157075.0, 7613.27001953125),
}

# Morpho-MNIST morphometric [min, max] (reference datasets.py:230-233)
MORPHOMNIST_MIN_MAX = {
    "thickness": (0.87598526, 6.255515),
    "intensity": (66.601204, 254.90317),
}


def get_attr_max_min(attr: str) -> Tuple[float, float]:
    """(max, min) for UKBB attributes (reference datasets.py:89-98)."""
    if attr not in UKBB_ATTR_MAX_MIN:
        raise NotImplementedError(attr)
    return UKBB_ATTR_MAX_MIN[attr]


def normalize(x, x_min: float, x_max: float, zero_one: bool = False):
    """Min-max normalize to [0,1] or [-1,1] (reference utils.py:43-51)."""
    x = (x - x_min) / (x_max - x_min)
    return x if zero_one else 2 * x - 1


def log_standardize(x):
    """log, then standardise to mean 0 and std 1 (reference utils.py:54-55)."""
    log_x = np.log(np.clip(x, 1e-12, None))
    std = max(float(log_x.std()), 1e-12)
    return (log_x - log_x.mean()) / std
