"""The mimic192 slice as a whole: the port's DSCM.forward with ChestPGM as PGM
and as predictor (the GroupNorm ResNet-18 trunk), the Gumbel-Max finding and
the parents age, race(3), sex, finding as the VAE's 6-wide context, against
the JAX package's:
on a reduced mimic192 config (the flagship's GELU blocks, z_max_res and
bias_max_res below input_res) with seeded weights, in float32 and bf16,
do(age) and do(finding), with the tolerances of
tests/test_torch_ukbb_dscm.py. Every draw is injected: the posterior normals
and the Gumbel posterior's two draws. The committed flagship's forward is in
tests/test_torch_mimic_flagship.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.config import get_config as jget
from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.pgm.dscm import DSCM as JDSCM
from causal_gen_tpu_torch.config import get_config as tget
from causal_gen_tpu_torch.models.hvae import HVAE
from causal_gen_tpu_torch.pgm.dscm import DSCM, vae_preprocess

from tests.test_torch_mimic_pgm import mimic_obs, pgm_pair, torch_attrs
from tests.test_torch_ukbb import BF16_SCALE_TOL, _close, _scalar_close
from tests.test_torch_ukbb_pgm import ARCH
from tests.torch_parity import (
    load_jax_params,
    nchw,
    nhwc,
    patch_jax_gumbel,
    patch_jax_nll_with_port,
    patch_jax_noise,
)

torch.set_num_threads(1)

RES = ARCH["input_res"]
N = 4
N_STOCHASTIC = 7  # decoder blocks at res <= 16
MIMIC_VARS = ("sex", "age", "race", "finding")


def _cfgs(dtype):
    return (jget("mimic192", dtype=dtype, bs=N, **ARCH),
            tget("mimic192", dtype=dtype, bs=N, **ARCH))


@functools.cache
def _vae_pair(dtype):
    """The reduced mimic192 HVAE on both sides (the zero-initialised leaves
    made random), cached per dtype."""
    jcfg, tcfg = _cfgs(dtype)
    assert tcfg.block_version is None and tcfg.context_dim == 6
    jvae = JHVAE(cfg=jcfg)
    x, pa = jnp.zeros((1, RES, RES, 1)), jnp.zeros((1, jcfg.context_dim))
    params = jax.jit(lambda k: jvae.init({"params": k, "sample": k}, x, pa, beta=jcfg.beta,
                                         train=False))(jax.random.PRNGKey(0))["params"]
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 1000))
    params = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(next(keys), a.shape)
                          if not a.any() else a, params)
    tvae = HVAE(tcfg, device="cpu")
    load_jax_params(tvae, params)
    return jvae, params, tvae


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("do", [{"age": [-0.9, 0.9, -0.9, 0.9]}, {"finding": "flip"}])
def test_dscm_forward_matches_jax(monkeypatch, dtype, do):
    bf16 = dtype == "bfloat16"
    jvae, vae_params, tvae = _vae_pair(dtype)
    jcfg, tcfg = _cfgs(dtype)
    jpgm, pgm_params, tpgm, _, _ = pgm_pair(seed=5, res=RES)
    jpred, pred_params, tpred, _, _ = pgm_pair(seed=6, setup_predictors=True, res=RES)
    obs = mimic_obs(seed=7, n=N, res=RES)
    attrs = {k: jnp.asarray(v) for k, v in obs.items() if k != "x"}
    jdscm = JDSCM(cfg=jcfg, pgm=jpgm, predictor=jpred, vae=jvae, elbo_constraint=1.8)
    tdscm = DSCM(tcfg, tpgm, tpred, tvae, elbo_constraint=1.8)
    rec = patch_jax_noise(monkeypatch, seed=21)
    gum = patch_jax_gumbel(monkeypatch, seed=22)
    patch_jax_nll_with_port(monkeypatch)
    jdo = {k: (1.0 - attrs[k]) if v == "flip" else jnp.asarray(v, jnp.float32)[:, None]
           for k, v in do.items()}
    ref = jax.jit(lambda *a: jdscm.forward(*a, jax.random.PRNGKey(0)))(
        jdscm.init_trainable(vae_params), {"pgm": pgm_params, "predictor": pred_params},
        {k: jnp.asarray(v) for k, v in obs.items()}, jdo)
    assert len(rec.draws) == 2 * N_STOCHASTIC and len(gum.draws) == 2
    normals = rec.torch_noise()
    noise = normals[:N_STOCHASTIC] + gum.torch_draws() + normals[N_STOCHASTIC:]
    tobs = {"x": nchw(obs["x"]), **torch_attrs(obs)}
    with torch.no_grad():
        out = tdscm.forward(tobs, torch_attrs(jdo), noise=noise)
    for k in MIMIC_VARS:
        np.testing.assert_allclose(out["cfs"][k].numpy(), np.asarray(ref["cfs"][k]),
                                   err_msg=k, atol=1e-5, rtol=1e-5)
    if "age" in do:  # the finding followed the Gumbel posterior on some rows
        assert (out["cfs"]["finding"].numpy() != obs["finding"]).any()
    for k in ("elbo", "nll", "kl"):
        _scalar_close(out[k], ref[k], bf16, k)
    if not bf16:
        _close(nhwc(out["cfs"]["x"]), ref["cfs"]["x"], bf16, "cf x")
        for k in ("aux_loss", "loss"):
            _scalar_close(out[k], ref[k], bf16, k)
        return
    # bf16: the pixel-noise transfer's bound from the port's own decodes
    pa = torch_attrs(obs)
    with torch.no_grad():
        zs = tvae.abduct(tobs["x"], vae_preprocess(tcfg, pa),
                         noise=iter(normals[N_STOCHASTIC:]))
        rec_loc, rec_scale = tvae.forward_latents(zs, vae_preprocess(tcfg, pa))
        cf_pa = {k: v for k, v in out["cfs"].items() if k != "x"}
        _, cf_scale = tvae.forward_latents(zs, vae_preprocess(tcfg, cf_pa))
    u = (tobs["x"] - rec_loc) / rec_scale
    bound = BF16_SCALE_TOL * (1 + 2 * (cf_scale * u).abs() + cf_scale / rec_scale)
    err = (out["cfs"]["x"] - nchw(np.asarray(ref["cfs"]["x"]))).abs()
    assert (err <= bound).all(), (err / bound).max().item()
    for k in ("aux_loss", "loss"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=BF16_SCALE_TOL, err_msg=k)


def test_vae_context_is_age_race_sex_finding():
    """vae_preprocess for mimic192: the parents in parents_x order, race
    one-hot, no rescaling (causal_gen_tpu/pgm/dscm.py:62-73)."""
    obs = torch_attrs(mimic_obs(seed=3, n=5))
    pa = vae_preprocess(tget("mimic192"), obs)
    want = torch.cat([obs["age"], obs["race"], obs["sex"], obs["finding"]], dim=1)
    assert pa.shape == (5, 6)
    torch.testing.assert_close(pa, want, rtol=0, atol=0)
