"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

The same inputs, made by numpy from a seed, go through a JAX function and its
counterpart in ``causal_gen_tpu_torch``. Parameters come from the flax
module's ``init`` and are converted with ``causal_gen_tpu_torch.convert``.
Noise reaches the JAX HVAE through a patched ``sample_gaussian`` that draws
from a seeded numpy queue and records each draw in order; the recorded draws
then go into the port as ``noise=``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import torch

from causal_gen_tpu_torch.convert import params_from_jax


def to_numpy(tree: Any) -> Any:
    """A flax parameter tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def load_jax_params(module: torch.nn.Module, tree: Any, allow_missing: str = None) -> None:
    """Load a flax tree into ``module``; a key the tree lacks must start with
    ``allow_missing`` (flax creates a submodule's params only when it runs)."""
    missing, unexpected = module.load_state_dict(params_from_jax(to_numpy(tree)), strict=False)
    assert not unexpected, unexpected
    assert all(allow_missing and k.startswith(allow_missing) for k in missing), missing


def nchw(a) -> torch.Tensor:
    """NHWC array -> NCHW float32 tensor."""
    return torch.tensor(np.asarray(a, np.float32).transpose(0, 3, 1, 2))


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW tensor -> NHWC numpy array."""
    return t.detach().cpu().numpy().transpose(0, 2, 3, 1)


def small_morpho_cfg(jax_side: bool, res: int = 16, **overrides):
    """The small Morpho-MNIST config of tests/test_dscm.py::build_dscm."""
    if jax_side:
        from causal_gen_tpu.config import get_config
    else:
        from causal_gen_tpu_torch.config import get_config
    return get_config(
        "morphomnist", bs=8, input_res=res,
        enc_arch=f"{res}b1d2,{res // 2}b1d2,{res // 4}b1d4,1b1",
        dec_arch=f"1b1,{res // 4}b1,{res // 2}b1,{res}b1",
        widths=(8, 8, 16, 16), z_dim=4, bias_max_res=res, **overrides,
    )


class NoiseRecorder:
    """Replacement for ``causal_gen_tpu.models.hvae.sample_gaussian``: draws eps
    from a seeded numpy stream and records it (NHWC) in draw order."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.draws: List[np.ndarray] = []

    def __call__(self, key, loc, logscale):
        eps = self.rng.standard_normal(loc.shape).astype(np.float32)
        self.draws.append(eps)
        return loc + jnp.exp(logscale) * jnp.asarray(eps)

    def torch_noise(self) -> List[torch.Tensor]:
        return [nchw(e) for e in self.draws]


def patch_jax_noise(monkeypatch, seed: int) -> NoiseRecorder:
    import causal_gen_tpu.models.hvae as jax_hvae

    rec = NoiseRecorder(seed)
    monkeypatch.setattr(jax_hvae, "sample_gaussian", rec)
    return rec


def synth_batch(res: int, n: int, seed: int) -> Dict[str, np.ndarray]:
    """Synthetic Morpho-MNIST batch (NHWC x in [-1, 1])."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.uniform(-1, 1, (n, res, res, 1)).astype(np.float32),
        "thickness": rng.uniform(-0.8, 0.8, (n, 1)).astype(np.float32),
        "intensity": rng.uniform(-0.8, 0.8, (n, 1)).astype(np.float32),
        "digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)],
    }


def jax_batch(b: Dict[str, np.ndarray]) -> Dict[str, jax.Array]:
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: nchw(v) if k == "x" else torch.from_numpy(v) for k, v in b.items()}


def patch_jax_nll_with_port(monkeypatch) -> None:
    """Have the JAX DGaussNet evaluate its NLL with the port's function.

    XLA's float32 tanh on the CPU is off by several ulp near 1, PyTorch's by
    at most one, and the discretized-Gaussian NLL of a pixel in the far tail
    is a difference of two CDFs near 1 that carries only a few ulp: there the
    two packages differ by up to several nats per pixel. The tests that
    compare NLL-dependent outputs (ELBO, DSCM loss) therefore feed the JAX
    model's (loc, logscale) through one NLL evaluation; the mismatch itself is
    shown by test_torch_sample_kl.py::test_dgauss_nll_tail_follows_tanh_ulps.
    """
    import causal_gen_tpu.models.likelihoods as jax_lik
    from causal_gen_tpu_torch.ops.distributions import discretized_gaussian_nll

    def nll(loc, logscale, x):
        args = (torch.from_numpy(np.array(a, np.float32)) for a in (loc, logscale, x))
        return jnp.asarray(discretized_gaussian_nll(*args).numpy())

    monkeypatch.setattr(jax_lik, "discretized_gaussian_nll", nll)
