"""The slice as a whole: the port's ``DSCM.forward`` (abduct -> act -> predict
on Morpho-MNIST) against the JAX package's, with the same weights and the same
injected noise (1e-4), also with the abduction at a temperature, the
null-intervention identity, and one run of the port alone at the full
Morpho-MNIST width on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu_torch import resolve_device
from causal_gen_tpu_torch.config import get_config
from causal_gen_tpu_torch.models.hvae import HVAE
from causal_gen_tpu_torch.pgm.dscm import DSCM
from causal_gen_tpu_torch.pgm.flow_pgm import MorphoMNISTPGM

from tests.torch_parity import (
    jax_batch,
    load_jax_params,
    nhwc,
    patch_jax_nll_with_port,
    patch_jax_noise,
    small_morpho_cfg,
    synth_batch,
    to_numpy,
    torch_batch,
)

torch.set_num_threads(1)


def _pair():
    """The JAX DSCM of tests/test_dscm.py::build_dscm, with random spline and
    digit parameters, and the port's DSCM holding the same weights."""
    from tests.test_dscm import build_dscm

    jdscm, vae_params, frozen, _ = build_dscm()
    frozen = to_numpy(frozen)
    r = np.random.default_rng(7)
    for tree in frozen.values():
        for k in ("digit_logits", "thickness_widths", "thickness_heights",
                  "thickness_derivs", "thickness_lambdas"):
            tree[k] = r.normal(0, 1, tree[k].shape).astype(np.float32)
    vae = HVAE(small_morpho_cfg(False), device="cpu")
    load_jax_params(vae, vae_params)
    pgm = MorphoMNISTPGM(setup_predictors=False, device="cpu")
    load_jax_params(pgm, frozen["pgm"])
    pred = MorphoMNISTPGM(setup_predictors=True, input_res=16, device="cpu")
    load_jax_params(pred, frozen["predictor"], allow_missing="intensity_net")
    tdscm = DSCM(vae.cfg, pgm, pred, vae, elbo_constraint=1.8, lmbda_init=0.0, damping=100.0)
    return jdscm, jdscm.init_trainable(vae_params), frozen, tdscm


@pytest.mark.parametrize("particles,do", [
    (1, {"thickness": 0.5}),
    (1, {"intensity": -0.2}),
    (2, {"thickness": -0.4}),
])
def test_forward_matches_jax(monkeypatch, particles, do):
    jdscm, trainable, frozen, tdscm = _pair()
    batch = synth_batch(16, 8, seed=particles)
    rec = patch_jax_noise(monkeypatch, seed=21)
    patch_jax_nll_with_port(monkeypatch)  # see its docstring
    jdo = {k: jnp.full((8, 1), v) for k, v in do.items()}
    ref = jdscm.forward(trainable, frozen, jax_batch(batch), jdo, jax.random.PRNGKey(0),
                        cf_particles=particles)
    assert len(rec.draws) == 4 * (1 + particles)  # factual pass + each abduction
    tdo = {k: torch.full((8, 1), v) for k, v in do.items()}
    with torch.no_grad():
        out = tdscm.forward(torch_batch(batch), tdo, cf_particles=particles,
                            noise=rec.torch_noise())
    np.testing.assert_allclose(nhwc(out["cfs"]["x"]), np.asarray(ref["cfs"]["x"]), atol=1e-4)
    for k in ("thickness", "intensity", "digit"):
        np.testing.assert_allclose(out["cfs"][k].numpy(), np.asarray(ref["cfs"][k]), atol=1e-4)
    for k in ("elbo", "nll", "kl", "aux_loss", "loss"):
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
    if particles > 1:
        np.testing.assert_allclose(nhwc(out["var_cf_x"]), np.asarray(ref["var_cf_x"]), atol=1e-4)
    else:
        assert out["var_cf_x"] is None and ref["var_cf_x"] is None


@pytest.mark.parametrize("particles", [1, 2])
def test_forward_with_t_abduct_matches_jax(monkeypatch, particles):
    """t_abduct scales the abduction's posterior scales only; the decodes run
    at t = None on both sides."""
    jdscm, trainable, frozen, tdscm = _pair()
    batch = synth_batch(16, 8, seed=10 + particles)
    rec = patch_jax_noise(monkeypatch, seed=22)
    patch_jax_nll_with_port(monkeypatch)  # see its docstring
    ref = jdscm.forward(trainable, frozen, jax_batch(batch), {"thickness": jnp.full((8, 1), 0.3)},
                        jax.random.PRNGKey(1), cf_particles=particles, t_abduct=0.1)
    assert len(rec.draws) == 4 * (1 + particles)
    with torch.no_grad():
        out = tdscm.forward(torch_batch(batch), {"thickness": torch.full((8, 1), 0.3)},
                            cf_particles=particles, noise=rec.torch_noise(), t_abduct=0.1)
        at_one = tdscm.forward(torch_batch(batch), {"thickness": torch.full((8, 1), 0.3)},
                               cf_particles=particles, noise=rec.torch_noise())
    np.testing.assert_allclose(nhwc(out["cfs"]["x"]), np.asarray(ref["cfs"]["x"]), atol=1e-4)
    for k in ("elbo", "nll", "kl", "aux_loss", "loss"):
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
    # the temperature reached the abduction: cf_x moved
    assert (out["cfs"]["x"] - at_one["cfs"]["x"]).abs().max() > 1e-3


@pytest.mark.parametrize("null_do", ["observed", "empty"])
def test_null_intervention_returns_the_observation(null_do):
    """do(thickness = observed), or no intervention, gives cf_x == x up to the
    flow round trip: cf parents == parents, so cf_loc == rec_loc."""
    _, _, _, tdscm = _pair()
    obs = torch_batch(synth_batch(16, 8, seed=5))
    do = {"thickness": obs["thickness"]} if null_do == "observed" else {}
    with torch.no_grad():
        out = tdscm.forward(obs, do, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out["cfs"]["x"].numpy(), obs["x"].numpy(), atol=1e-4)


def test_full_width_forward_on_cpu():
    """The port alone at the registry's Morpho-MNIST widths, bs 2."""
    g = torch.Generator().manual_seed(0)
    cfg = get_config("morphomnist", bs=2)
    vae = HVAE(cfg, device="cpu", generator=g)
    pgm = MorphoMNISTPGM(setup_predictors=False, device="cpu", generator=g)
    pred = MorphoMNISTPGM(setup_predictors=True, input_res=32, device="cpu", generator=g)
    dscm = DSCM(cfg, pgm, pred, vae, elbo_constraint=1.8)
    obs = torch_batch(synth_batch(32, 2, seed=0))
    with torch.no_grad():
        out = dscm.forward(obs, {"thickness": torch.full((2, 1), 0.5)}, cf_particles=2,
                           generator=g)
    assert out["cfs"]["x"].shape == (2, 1, 32, 32)
    assert torch.all(out["cfs"]["x"].abs() <= 1.0)
    assert torch.all(out["var_cf_x"] >= 0)
    for k in ("elbo", "nll", "kl", "aux_loss", "loss"):
        assert out[k].shape == () and torch.isfinite(out[k]), k
    assert torch.allclose(out["cfs"]["thickness"], torch.full((2, 1), 0.5))


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            MorphoMNISTPGM(setup_predictors=False)


def test_vae_preprocess_matches_jax_for_ukbb_parents():
    """The UKBB [-1,1] -> log-standard parent conversion, constants copied."""
    from causal_gen_tpu.config import get_config as jget
    from causal_gen_tpu.pgm.dscm import vae_preprocess as jax_pre
    from causal_gen_tpu_torch.pgm.dscm import vae_preprocess

    rng = np.random.default_rng(0)
    pa = {k: rng.uniform(-1, 1, (6, 1)).astype(np.float32)
          for k in ("age", "brain_volume", "ventricle_volume")}
    pa["sex"] = rng.integers(0, 2, (6, 1)).astype(np.float32)
    pa["mri_seq"] = rng.integers(0, 2, (6, 1)).astype(np.float32)
    ref = jax_pre(jget("ukbb64"), {k: jnp.asarray(v) for k, v in pa.items()})
    out = vae_preprocess(get_config("ukbb64"), {k: torch.from_numpy(v) for k, v in pa.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
