"""The port's HVAE against the JAX package's: the ELBO, ``sample``, ``abduct``
and ``forward_latents``, at temperatures too, with converted parameters and
the same injected noise, on the small Morpho-MNIST config of
tests/test_dscm.py (and a small Colour-MNIST one with the DMoL head for
``sample``). Tolerances: 1e-5 abs per latent and image (1e-5 abs + 1e-5 rel
for ``sample``), 1e-4 rel on the ELBO terms. The NLL term is evaluated by one
function on both sides (see torch_parity.patch_jax_nll_with_port)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.train.vae_trainer import init_model_params
from causal_gen_tpu_torch.models.hvae import HVAE, plan_decoder_blocks

from tests.torch_parity import (
    load_jax_params,
    nchw,
    nhwc,
    patch_jax_head_draws,
    patch_jax_nll_with_port,
    patch_jax_noise,
    small_morpho_cfg,
    synth_batch,
)

torch.set_num_threads(1)


def _pair(**overrides):
    jcfg = small_morpho_cfg(True, **overrides)
    jvae = JHVAE(cfg=jcfg)
    params = init_model_params(jcfg, jvae, jax.random.PRNGKey(0))
    tvae = HVAE(small_morpho_cfg(False, **overrides), device="cpu")
    load_jax_params(tvae, params)
    return jvae, params, tvae


def _cmnist_dmol_pair():
    """The small Colour-MNIST config of tests/test_torch_dmol.py with the
    diag_dmol head."""
    from tests.test_torch_dmol import _cmnist_cfg

    jcfg = _cmnist_cfg(True)
    jvae = JHVAE(cfg=jcfg)
    params = init_model_params(jcfg, jvae, jax.random.PRNGKey(0))
    tvae = HVAE(_cmnist_cfg(False), device="cpu")
    load_jax_params(tvae, params)
    return jvae, params, tvae


def _batch(seed=0, n=4):
    b = synth_batch(16, n, seed)
    pa = np.concatenate([b["thickness"], b["intensity"], b["digit"]], axis=1)
    return b["x"], pa


def test_config_registry_is_a_copy():
    from causal_gen_tpu.config import CONFIG_REGISTRY as jreg
    from causal_gen_tpu_torch.config import CONFIG_REGISTRY as treg

    assert sorted(jreg) == sorted(treg)
    for name in jreg:
        assert dataclasses.asdict(jreg[name]) == dataclasses.asdict(treg[name]), name
        assert jreg[name].enc_stages == tuple(
            type(s)(**dataclasses.asdict(s)) for s in jreg[name].enc_stages)
        assert [dataclasses.asdict(s) for s in jreg[name].dec_stages] == [
            dataclasses.asdict(s) for s in treg[name].dec_stages]


@pytest.mark.parametrize("name", ["morphomnist", "ukbb192", "mimic192"])
def test_decoder_plan_matches_jax(name):
    from causal_gen_tpu.config import get_config as jget
    from causal_gen_tpu.models.hvae import plan_decoder_blocks as jplan
    from causal_gen_tpu_torch.config import get_config as tget

    assert plan_decoder_blocks(tget(name)) == jplan(jget(name))


@pytest.mark.parametrize("free_bits", [0.0, 0.05])
def test_elbo_matches_jax(monkeypatch, free_bits):
    jvae, params, tvae = _pair(kl_free_bits=free_bits)
    x, pa = _batch()
    rec = patch_jax_noise(monkeypatch, seed=11)
    patch_jax_nll_with_port(monkeypatch)  # see its docstring
    ref = jvae.apply({"params": params}, jnp.asarray(x), jnp.asarray(pa), beta=1.0,
                     train=False, rngs={"sample": jax.random.PRNGKey(3)})
    assert len(rec.draws) == 4  # one posterior draw per stochastic block
    with torch.no_grad():
        out = tvae(nchw(x), torch.from_numpy(pa), beta=1.0, noise=iter(rec.torch_noise()))
    for k in ("elbo", "nll", "kl"):
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4)


def test_abduct_and_forward_latents_match_jax(monkeypatch):
    jvae, params, tvae = _pair()
    x, pa = _batch(seed=1)
    cf_pa = _batch(seed=2)[1]
    rec = patch_jax_noise(monkeypatch, seed=12)
    jz = jvae.apply({"params": params}, jnp.asarray(x), jnp.asarray(pa),
                    method=jvae.abduct, rngs={"sample": jax.random.PRNGKey(4)})
    with torch.no_grad():
        tz = tvae.abduct(nchw(x), torch.from_numpy(pa), noise=iter(rec.torch_noise()))
    assert len(tz) == len(jz) == 4
    for a, b in zip(tz, jz):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=1e-5)
    jloc, jscale = jvae.apply({"params": params}, jz, jnp.asarray(cf_pa),
                              method=jvae.forward_latents)
    with torch.no_grad():
        loc, scale = tvae.forward_latents([nchw(z) for z in jz], torch.from_numpy(cf_pa))
    np.testing.assert_allclose(nhwc(loc), np.asarray(jloc), atol=1e-5)
    np.testing.assert_allclose(nhwc(scale), np.asarray(jscale), atol=1e-5)


def test_forward_latents_prior_draws_match_jax(monkeypatch):
    """Blocks without a given latent draw from the prior, through the noise."""
    jvae, params, tvae = _pair()
    x, pa = _batch(seed=3)
    jz = jvae.apply({"params": params}, jnp.asarray(x), jnp.asarray(pa),
                    method=jvae.abduct, rngs={"sample": jax.random.PRNGKey(5)})
    rec = patch_jax_noise(monkeypatch, seed=13)
    jloc, _ = jvae.apply({"params": params}, jz[:2], jnp.asarray(pa),
                         method=jvae.forward_latents, rngs={"sample": jax.random.PRNGKey(6)})
    assert len(rec.draws) == 2
    with torch.no_grad():
        loc, _ = tvae.forward_latents([nchw(z) for z in jz[:2]], torch.from_numpy(pa),
                                      noise=iter(rec.torch_noise()))
    np.testing.assert_allclose(nhwc(loc), np.asarray(jloc), atol=1e-5)


@pytest.mark.parametrize("head", ["dgauss", "dmol"])
@pytest.mark.parametrize("return_loc", [True, False])
@pytest.mark.parametrize("t", [None, 0.7])
def test_sample_matches_jax(monkeypatch, head, return_loc, t):
    """Every stochastic block draws from its prior at t, then the head gives
    its loc or a sample at t; the prior normals and the head's draw (a normal,
    or the DMoL uniforms) go into the port as noise, in that order."""
    jvae, params, tvae = _pair() if head == "dgauss" else _cmnist_dmol_pair()
    pa = np.random.default_rng(4).uniform(-1, 1, (4, tvae.cfg.context_dim)).astype(np.float32)
    prior = patch_jax_noise(monkeypatch, seed=14)
    heads = patch_jax_head_draws(monkeypatch, seed=15)
    jx, js = jvae.apply({"params": params}, jnp.asarray(pa), return_loc, t,
                        method=jvae.sample, rngs={"sample": jax.random.PRNGKey(7)})
    assert len(prior.draws) == 4 and len(heads.draws) == (0 if return_loc else 1)
    with torch.no_grad():
        x, s = tvae.sample(torch.from_numpy(pa), return_loc, t,
                           noise=iter(prior.torch_noise() + heads.draws))
    assert x.shape == (4, tvae.cfg.input_channels, 16, 16)
    np.testing.assert_allclose(nhwc(x), np.asarray(jx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(nhwc(s), np.asarray(js), atol=1e-5, rtol=1e-5)


def test_abduct_and_forward_latents_at_a_temperature_match_jax(monkeypatch):
    """abduct(t=0.1), then forward_latents(t=0.5) with the last two latents
    None: those blocks draw from their priors at t = 0.5."""
    jvae, params, tvae = _pair()
    x, pa = _batch(seed=5)
    rec = patch_jax_noise(monkeypatch, seed=16)
    jz = jvae.apply({"params": params}, jnp.asarray(x), jnp.asarray(pa), t=0.1,
                    method=jvae.abduct, rngs={"sample": jax.random.PRNGKey(8)})
    with torch.no_grad():
        tz = tvae.abduct(nchw(x), torch.from_numpy(pa), noise=iter(rec.torch_noise()), t=0.1)
    for a, b in zip(tz, jz):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=1e-5)
    rec = patch_jax_noise(monkeypatch, seed=17)
    jloc, jscale = jvae.apply({"params": params}, list(jz[:2]) + [None, None], jnp.asarray(pa),
                              t=0.5, method=jvae.forward_latents,
                              rngs={"sample": jax.random.PRNGKey(9)})
    assert len(rec.draws) == 2
    with torch.no_grad():
        loc, scale = tvae.forward_latents([nchw(z) for z in jz[:2]] + [None, None],
                                          torch.from_numpy(pa),
                                          noise=iter(rec.torch_noise()), t=0.5)
    np.testing.assert_allclose(nhwc(loc), np.asarray(jloc), atol=1e-5)
    np.testing.assert_allclose(nhwc(scale), np.asarray(jscale), atol=1e-5)


def test_unported_config_features_raise():
    for kw in (dict(cond_prior=True), dict(q_correction=True), dict(spatial_dims=3)):
        with pytest.raises(NotImplementedError):
            HVAE(small_morpho_cfg(False, **kw), device="cpu")
