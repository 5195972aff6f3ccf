"""Flax parameter trees -> PyTorch ``state_dict``s.

``params_from_jax`` takes the nested dict of numpy arrays that a flax module's
``init`` (or an Orbax restore, on a machine with JAX) gives, and returns the
``state_dict`` of the port's counterpart module: the HVAE, the PGM or the
predictor. It reads numpy arrays only, so it imports no JAX; turning an
Orbax checkpoint into such a tree needs JAX and so runs on the JAX side.

The port's modules carry flax's names, so a key maps by its path:
``decoder/blocks_0/prior/Conv_0/kernel`` -> ``decoder.blocks_0.prior.Conv_0.weight``.
Leaves change as follows:

- conv ``kernel`` (4-D, HWIO) -> ``weight`` in OIHW (the 1x1 convs of the
  heads too: DmolNet's ``likelihood/conv`` keeps the JAX channel order of
  its 10K outputs);
- dense ``kernel`` (2-D, (in, out)) -> ``weight`` in (out, in);
- norm ``scale`` -> ``weight``;
- the decoder's per-resolution ``bias_<r>`` (1, r, r, C) -> (1, C, r, r);
- every other leaf (biases, ``x_logscale_kernel``, spline and logit
  parameters) is copied as it is.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_RES_BIAS = re.compile(r"bias_\d+")


def _leaf(path: str, name: str, value: np.ndarray) -> tuple:
    a = np.asarray(value, dtype=np.float32)
    if name == "kernel" and a.ndim == 4:
        return "weight", a.transpose(3, 2, 0, 1)
    if name == "kernel" and a.ndim == 2:
        return "weight", a.T
    if name == "kernel":
        raise ValueError(f"{path}: kernel of rank {a.ndim} has no converter")
    if name == "scale":
        return "weight", a
    if _RES_BIAS.fullmatch(name) and a.ndim == 4:
        return name, a.transpose(0, 3, 1, 2)
    return name, a


def params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """``state_dict`` of the port's module for a flax parameter ``tree``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(params_from_jax(value, path + "."))
            continue
        name, a = _leaf(path, key, value)
        out[prefix + name] = torch.tensor(a)
    return out
