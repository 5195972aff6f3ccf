"""Batched host-side image augmentations (numpy, NHWC).

Counterpart of ``causal_gen_tpu/data/augment.py``. ``gather_crop_flip`` is the
plain version of the native pass (``data/native.py``, ``native/augment.cpp``),
which the loader runs: whole batches gathered, zero-padded, randomly cropped
and flipped at once with numpy, with the pass's random draws in its order.
The tests hold the pass against it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_zero(x: np.ndarray, pad_h: int, pad_w: int) -> np.ndarray:
    """Zero-pad an NHWC batch spatially (torchvision's default fill=0)."""
    return np.pad(x, ((0, 0), (pad_h, pad_h), (pad_w, pad_w), (0, 0)))


def gather_crop_flip(images: np.ndarray, idx: np.ndarray, rng: np.random.Generator,
                     out_size: Tuple[int, int], padding: Tuple[int, int] = (0, 0),
                     hflip_p: float = 0.0) -> np.ndarray:
    """images[idx], zero-padded by ``padding`` = (pad_h, pad_w), cropped at a
    random origin to ``out_size`` and flipped left-right with probability
    ``hflip_p`` (TF.RandomCrop + TF.RandomHorizontalFlip, reference
    datasets.py:276-289, 102-120). Draws the crop rows, then the columns, then
    (only if hflip_p > 0) the flips, one per image."""
    n = len(idx)
    _, h, w, _ = images.shape
    out_h, out_w = out_size
    ph, pw = padding
    ys = rng.integers(0, h + 2 * ph - out_h + 1, size=n)
    xs = rng.integers(0, w + 2 * pw - out_w + 1, size=n)
    flips = rng.random(n) < hflip_p if hflip_p > 0 else np.zeros(n, bool)
    x = pad_zero(images[np.asarray(idx)], ph, pw)
    rows = ys[:, None, None] + np.arange(out_h)[None, :, None]
    cols = xs[:, None, None] + np.arange(out_w)[None, None, :]
    out = x[np.arange(n)[:, None, None], rows, cols]
    out[flips] = out[flips, :, ::-1]
    return out


def center_pad(x: np.ndarray, pad: int) -> np.ndarray:
    """Symmetric zero pad (TF.Pad eval transform, datasets.py:284-288)."""
    return pad_zero(x, pad, pad)
