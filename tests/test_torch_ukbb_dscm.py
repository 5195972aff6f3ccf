"""The ukbb192 slice as a whole: the port's DSCM.forward (abduct -> act ->
predict) with the UKBB FlowPGM as PGM and as predictor
(causal_gen_tpu/cli/train_cf.py:196-230) and ukbb_preprocess to the VAE's
parents, against the JAX package's on the reduced config of
tests/test_torch_ukbb.py, with the same weights and injected noise, in
float32 and in bf16, do() on a volume and on a binary root.

Tolerances: float32 1e-5 abs + rel (the ELBO terms 1e-5 rel). bf16: the PGM's
counterfactual parents 1e-5 (the PGM is float32), the ELBO terms 2e-2 rel as
in tests/test_torch_ukbb.py. The pixel-noise transfer cf_x = cf_loc +
cf_scale u, u = (x - rec_loc) / rec_scale, multiplies the decoders'
differences: with decoded locs within e and scales within e relative
(e = 2^-4), a pixel of cf_x is within e (1 + 2 |cf_scale u| + cf_scale /
rec_scale), computed from the port's own decodes (measured up to 0.63 of
it); aux_loss and loss, which read cf_x, within 2^-4 rel (measured up to
1.3%). The NLL term goes through one function on both sides (see
torch_parity.patch_jax_nll_with_port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.pgm.dscm import DSCM as JDSCM
from causal_gen_tpu_torch.pgm.dscm import DSCM, vae_preprocess

from tests.test_torch_ukbb import (
    BF16_SCALE_TOL,
    F32_TOL,
    N_STOCHASTIC,
    _cfgs,
    _close,
    _scalar_close,
    _vae_pair,
)
from tests.test_torch_ukbb_pgm import N, PGM_VARS, pgm_pair, torch_attrs
from tests.torch_parity import nchw, nhwc, patch_jax_nll_with_port, patch_jax_noise

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("do", [{"ventricle_volume": 0.5}, {"sex": "flip"}])
def test_dscm_forward_matches_jax(monkeypatch, dtype, do):
    """abduct -> act -> predict on ukbb parents: the FlowPGM as PGM and as
    predictor (cli/train_cf.py:196-230), ukbb_preprocess to the VAE's
    parents."""
    bf16 = dtype == "bfloat16"
    jvae, vae_params, tvae = _vae_pair(dtype)
    jcfg, tcfg = _cfgs(dtype)
    jpgm, pgm_params, tpgm, obs, attrs = pgm_pair(seed=5, setup_predictors=False)
    jpred, pred_params, tpred, _, _ = pgm_pair(seed=6)
    jdscm = JDSCM(cfg=jcfg, pgm=jpgm, predictor=jpred, vae=jvae, elbo_constraint=1.8)
    tdscm = DSCM(tcfg, tpgm, tpred, tvae, elbo_constraint=1.8)
    frozen = {"pgm": pgm_params, "predictor": pred_params}
    rec = patch_jax_noise(monkeypatch, seed=21)
    patch_jax_nll_with_port(monkeypatch)
    jdo = {k: (1.0 - attrs["sex"]) if v == "flip" else jnp.full((N, 1), v)
           for k, v in do.items()}
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    ref = jax.jit(lambda *a: jdscm.forward(*a, jax.random.PRNGKey(0)))(
        jdscm.init_trainable(vae_params), frozen, jobs, jdo)
    assert len(rec.draws) == 2 * N_STOCHASTIC  # factual pass + abduction
    tobs = {"x": nchw(obs["x"]), **torch_attrs(obs)}
    noise = rec.torch_noise()
    with torch.no_grad():
        out = tdscm.forward(tobs, torch_attrs(jdo), noise=noise)
    for k in PGM_VARS:
        np.testing.assert_allclose(out["cfs"][k].numpy(), np.asarray(ref["cfs"][k]),
                                   err_msg=k, **F32_TOL)
    for k in ("elbo", "nll", "kl"):
        _scalar_close(out[k], ref[k], bf16, k)
    if not bf16:
        _close(nhwc(out["cfs"]["x"]), ref["cfs"]["x"], bf16, "cf x")
        for k in ("aux_loss", "loss"):
            _scalar_close(out[k], ref[k], bf16, k)
        return
    # bf16: the transfer's bound from the port's own decodes (module docstring)
    pa = torch_attrs(obs)
    with torch.no_grad():
        zs = tvae.abduct(tobs["x"], vae_preprocess(tcfg, pa), noise=iter(noise[N_STOCHASTIC:]))
        rec_loc, rec_scale = tvae.forward_latents(zs, vae_preprocess(tcfg, pa))
        cf_pa = {k: v for k, v in out["cfs"].items() if k != "x"}
        _, cf_scale = tvae.forward_latents(zs, vae_preprocess(tcfg, cf_pa))
    u = (tobs["x"] - rec_loc) / rec_scale
    bound = BF16_SCALE_TOL * (1 + 2 * (cf_scale * u).abs() + cf_scale / rec_scale)
    err = (out["cfs"]["x"] - nchw(np.asarray(ref["cfs"]["x"]))).abs()
    assert (err <= bound).all(), (err / bound).max().item()
    for k in ("aux_loss", "loss"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=BF16_SCALE_TOL, err_msg=k)
