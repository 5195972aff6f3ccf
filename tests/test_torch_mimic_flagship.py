"""The committed mimic192 flagship (checkpoints/mimic192_flagship: HVAE, PGM
and predictor, EMA weights, converted) through the port's DSCM.forward at bs
1, in float32 and bf16, against the JAX package's on the same batch and
injected draws (torch_parity.flagship_forward_check states the tolerances).
The reduced mimic192 slice is in tests/test_torch_mimic_dscm.py.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

from tests.torch_parity import flagship_forward_check

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@functools.cache
def _flagship_obs():
    rng = np.random.default_rng(0)
    x = np.kron(rng.uniform(-1, 1, (1, 24, 24, 1)), np.ones((1, 8, 8, 1)))
    return {"x": x.astype(np.float32), "age": np.full((1, 1), 0.3, np.float32),
            "race": np.eye(3, dtype=np.float32)[[1]], "sex": np.ones((1, 1), np.float32),
            "finding": np.zeros((1, 1), np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mimic192_flagship_forward_matches_jax(monkeypatch, dtype):
    """The committed mimic192 DSCM (EMA weights), do(age = -0.6), bs 1: the
    port's DSCM.forward against the JAX package's."""
    flagship_forward_check(monkeypatch, str(ROOT / "checkpoints" / "mimic192_flagship"),
                           dtype, _flagship_obs(), {"age": np.full((1, 1), -0.6, np.float32)})
