"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

The same inputs, made by numpy from a seed, go through a JAX function and its
counterpart in ``causal_gen_tpu_torch``. Parameters come from the flax
module's ``init`` and are converted with ``causal_gen_tpu_torch.convert``.
Noise reaches the JAX HVAE through a patched ``sample_gaussian`` that draws
from a seeded numpy queue and records each draw in order; the recorded draws
then go into the port as ``noise=``. The heads' own draws are caught the same
way: DGaussNet's normal through a patched ``jax.random.normal``, and the DMoL
sampler's key, from which ``jax_dmol_uniforms`` rebuilds its two uniform
draws.
"""

from __future__ import annotations

from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.train.state import init_train_state as jinit_state
from causal_gen_tpu.train.vae_trainer import _make_step_body, init_model_params
from causal_gen_tpu_torch.convert import params_from_jax
from causal_gen_tpu_torch.models.hvae import HVAE, plan_decoder_blocks
from causal_gen_tpu_torch.train.state import init_train_state
from causal_gen_tpu_torch.train.vae_trainer import train_step


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


def run_steps_against_jax(jcfg, tcfg, channels, context_dim, monkeypatch, n_steps=4,
                          nan_step=2):
    """``n_steps`` train steps of both packages from converted parameters, on
    the same uint8 batches (accu_steps microbatches each) and noise. Step
    ``nan_step`` has a NaN parent, so both skip it. Returns the per-step
    metrics of both and the two final states.

    The JAX step is jitted: its patched sample_gaussian draws once, at trace
    time, and the compiled step reuses those draws for every microbatch and
    every step, so the port is fed the same draws each time."""
    jvae = JHVAE(cfg=jcfg)
    params = init_model_params(jcfg, jvae, jax.random.PRNGKey(0))
    jstate = jinit_state(jcfg, params)
    tvae = HVAE(tcfg, device="cpu")
    load_jax_params(tvae, params)
    tstate = init_train_state(tcfg, tvae)
    rec = patch_jax_noise(monkeypatch, seed=5)
    jstep = jax.jit(_make_step_body(jcfg, jvae))
    n_stochastic = sum(1 for r, _ in plan_decoder_blocks(tcfg) if r <= tcfg.z_max_res)
    accu, res = jcfg.accu_steps, jcfg.input_res
    micro = jcfg.bs // accu
    rng = np.random.default_rng(0)
    metrics = []
    for s in range(n_steps):
        x = rng.integers(0, 256, (accu, micro, res, res, channels)).astype(np.uint8)
        pa = rng.uniform(-1, 1, (accu, micro, context_dim)).astype(np.float32)
        if s == nan_step:
            pa[0, 0, 0] = np.nan
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "pa": jnp.asarray(pa)},
                           jax.random.PRNGKey(s))
        assert len(rec.draws) == n_stochastic  # one trace, one draw per stochastic block
        noise = [rec.torch_noise() for _ in range(accu)]
        batch = {"x": torch.from_numpy(x.reshape(accu * micro, res, res, channels))
                 .permute(0, 3, 1, 2).contiguous(),
                 "pa": torch.from_numpy(pa.reshape(accu * micro, context_dim))}
        tm = train_step(tcfg, tstate, batch, noise=noise)
        metrics.append(({k: float(v) for k, v in jax.device_get(jm).items()},
                        {k: float(v) for k, v in tm.items()}))
    return metrics, jstate, tstate


def assert_states_match(metrics, jstate, tstate, atol=1e-5):
    for s, (jm, tm) in enumerate(metrics):
        assert jm["skipped"] == tm["skipped"], s
        for k in ("elbo", "nll", "kl", "grad_norm"):
            if np.isnan(jm[k]):
                assert np.isnan(tm[k]), (s, k)
            else:
                assert tm[k] == pytest.approx(jm[k], rel=1e-4), (s, k, tm[k], jm[k])
    assert (tstate.step, tstate.skipped, tstate.ema_updates) == (
        int(jstate.step), int(jstate.skipped), int(jstate.ema_updates))
    for tree, module in ((jstate.params, tstate.model), (jstate.ema_params, tstate.ema)):
        ref = params_from_jax(to_numpy(tree))
        got = module.state_dict()
        assert sorted(ref) == sorted(got)
        errs = {k: (got[k] - ref[k]).abs() for k in ref}
        worst_key = max(errs, key=lambda k: errs[k].max())
        n_over = sum(int((e > atol).sum()) for e in errs.values())
        assert n_over == 0, (f"{n_over} elements differ by more than {atol}; worst "
                             f"{errs[worst_key].max().item():.3e} in {worst_key}")


def patch_jax_nll_with_port(monkeypatch) -> None:
    """Have the JAX DGaussNet evaluate its NLL, and the NLL's gradient, with
    the port's function.

    XLA's float32 tanh on the CPU is off by several ulp near 1, PyTorch's by
    at most one, and the discretized-Gaussian NLL of a pixel in the far tail
    is a difference of two CDFs near 1 that carries only a few ulp: there the
    two packages differ by up to several nats per pixel. The tests that
    compare NLL-dependent outputs (ELBO, DSCM loss, train steps) therefore
    feed the JAX model's (loc, logscale) through one NLL evaluation, and its
    cotangent through that evaluation's autograd; the mismatch itself is
    shown by test_torch_sample_kl.py::test_dgauss_nll_tail_follows_tanh_ulps.
    """
    import causal_gen_tpu.models.likelihoods as jax_lik
    from causal_gen_tpu_torch.ops.distributions import discretized_gaussian_nll

    def tensors(*arrays):
        return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]

    def value(loc, logscale, x):
        with torch.no_grad():
            return discretized_gaussian_nll(*tensors(loc, logscale, x)).numpy()

    def cotangents(loc, logscale, x, g):
        loc, logscale, x, g = tensors(loc, logscale, x, g)
        loc.requires_grad_()
        logscale.requires_grad_()
        out = discretized_gaussian_nll(loc, logscale, x)
        return tuple(t.numpy() for t in torch.autograd.grad(out, (loc, logscale), g))

    @jax.custom_vjp
    def nll(loc, logscale, x):
        return jax.pure_callback(value, jax.ShapeDtypeStruct(loc.shape[:1], jnp.float32),
                                 loc, logscale, x)

    def nll_fwd(loc, logscale, x):
        return nll(loc, logscale, x), (loc, logscale, x)

    def nll_bwd(res, g):
        loc, logscale, x = res
        shapes = tuple(jax.ShapeDtypeStruct(a.shape, jnp.float32) for a in (loc, logscale))
        d_loc, d_logscale = jax.pure_callback(cotangents, shapes, loc, logscale, x, g)
        return d_loc, d_logscale, jnp.zeros_like(x)

    nll.defvjp(nll_fwd, nll_bwd)
    monkeypatch.setattr(jax_lik, "discretized_gaussian_nll", nll)


def jax_dmol_uniforms(key, b: int, h: int, w: int, nr_mix: int = 10):
    """The two uniform draws of ``causal_gen_tpu.ops.dmol.
    sample_from_discretized_mix_logistic`` under ``key``, as NCHW tensors
    (u_mix (B,K,H,W), u (B,3,H,W)), made as that function makes them."""
    k_mix, k_u = jax.random.split(key)
    eps = jax.random.uniform(k_mix, (b, h, w, nr_mix), minval=1e-5, maxval=1.0 - 1e-5)
    u = jax.random.uniform(k_u, (b, h, w, 3), minval=1e-5, maxval=1.0 - 1e-5)
    return nchw(eps), nchw(u)


class HeadDrawRecorder:
    """Catches the draws of the JAX heads' ``sample(return_loc=False)``:
    DGaussNet's standard normal (drawn here from a seeded numpy stream) and the
    DMoL sampler's key (its uniforms rebuilt by ``jax_dmol_uniforms``). Each
    draw is kept in the form the port's head takes it."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.draws: List[Any] = []

    def normal(self, key, shape, dtype=jnp.float32):
        eps = self.rng.standard_normal(shape).astype(np.float32)
        self.draws.append(nchw(eps))
        return jnp.asarray(eps, dtype)

    def dmol_sampler(self, original):
        def sample(key, l, nr_mix, t=None):
            b, h, w, _ = l.shape
            self.draws.append(jax_dmol_uniforms(key, b, h, w, nr_mix))
            return original(key, l, nr_mix, t=t)
        return sample


def patch_jax_head_draws(monkeypatch, seed: int) -> HeadDrawRecorder:
    import causal_gen_tpu.ops.dmol as jax_dmol

    rec = HeadDrawRecorder(seed)
    monkeypatch.setattr(jax.random, "normal", rec.normal)
    monkeypatch.setattr(jax_dmol, "sample_from_discretized_mix_logistic",
                        rec.dmol_sampler(jax_dmol.sample_from_discretized_mix_logistic))
    return rec
