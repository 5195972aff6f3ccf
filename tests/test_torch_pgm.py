"""The port's Morpho-MNIST PGM and predictors against the JAX package's, with
converted parameters (1e-5 abs; the spline 1e-5 abs + rel): the linear
rational spline and its inverse, the counterfactual (exact flow abduction),
the anticausal log-probs and the predictions; plus the flax norm epsilon and
the exact GELU of the nets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.pgm import modules as jm
from causal_gen_tpu.pgm import transforms as jt
from causal_gen_tpu.pgm.flow_pgm import MorphoMNISTPGM as JPGM
from causal_gen_tpu_torch.pgm import modules as tm
from causal_gen_tpu_torch.pgm import transforms as tt
from causal_gen_tpu_torch.pgm.flow_pgm import MorphoMNISTPGM

from tests.torch_parity import load_jax_params, nchw, synth_batch, to_numpy

torch.set_num_threads(1)


def _spline_params(seed, k=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (1, n)).astype(np.float32) for n in (k, k, k - 1, k)]


def _splines(seed):
    p = _spline_params(seed)
    return jt.LinearRationalSpline(*(jnp.asarray(a) for a in p)), \
        tt.LinearRationalSpline(*(torch.from_numpy(a) for a in p))


@pytest.mark.parametrize("seed", [0, 1])
def test_spline_forward_inverse_match_jax(seed):
    """The knots are a cumsum, which XLA associates differently from PyTorch
    (one ulp apart), and in a narrow bin one ulp of a knot moves the logdet by
    ~2e-5 at |logdet| ~ 2.7: hence a relative term in the tolerance."""
    js, ts = _splines(seed)
    x = np.linspace(-4, 4, 401, dtype=np.float32)[:, None]
    for method in ("forward", "inverse"):
        jy, jld = getattr(js, method)(jnp.asarray(x))
        ty, tld = getattr(ts, method)(torch.from_numpy(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tld.numpy(), np.asarray(jld), rtol=1e-5, atol=1e-5)
    y, _ = ts.forward(torch.from_numpy(x))
    back, _ = ts.inverse(y)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def test_spline_inverse_at_bin_edges():
    """The bin search at the knots themselves, at +-bound and outside."""
    js, ts = _splines(2)
    _, yk = ts._params()[2:4]
    y = torch.cat([yk[0], torch.tensor([-3.5, 3.5])])[:, None].contiguous()
    jx, jld = js.inverse(jnp.asarray(y.numpy()))
    tx, tld = ts.inverse(y)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(tld.numpy(), np.asarray(jld), atol=1e-5)
    xk = ts._params()[1][0]
    np.testing.assert_allclose(tx[:-2, 0].numpy(), xk.numpy(), atol=1e-5)


def _pgms(seed=0, res=16):
    obs = synth_batch(res, 8, seed)
    attrs = {k: jnp.asarray(v) for k, v in obs.items() if k != "x"}
    rng = jax.random.PRNGKey(seed)
    jpgm = JPGM(setup_predictors=True, input_res=res)
    params = jpgm.init({"params": rng, "sample": rng}, jnp.asarray(obs["x"]),
                       method=jpgm.anticausal_logprob, **attrs)["params"]
    # give the zero-initialised spline, logits and flow net random values
    params = to_numpy(params)
    r = np.random.default_rng(seed + 100)
    for k in ("digit_logits", "thickness_widths", "thickness_heights", "thickness_derivs",
              "thickness_lambdas"):
        params[k] = r.normal(0, 1, params[k].shape).astype(np.float32)
    flow = JPGM(setup_predictors=False)
    params["intensity_net"] = to_numpy(flow.init({"params": rng, "sample": rng}, attrs)["params"]
                                       ["intensity_net"])
    tpgm = MorphoMNISTPGM(setup_predictors=True, input_res=res, device="cpu", scm_nets=True)
    load_jax_params(tpgm, params)
    return jpgm, params, tpgm, obs, attrs


@pytest.mark.parametrize("do", [
    {"thickness": 0.5},
    {"intensity": -0.3},
    {"digit": np.eye(10, dtype=np.float32)[[3] * 8]},
    {},
])
def test_counterfactual_matches_jax(do):
    jpgm, params, tpgm, obs, attrs = _pgms()
    jdo = {k: jnp.full((8, 1), v) if np.isscalar(v) else jnp.asarray(v) for k, v in do.items()}
    ref = jpgm.apply({"params": params}, attrs, jdo, method=jpgm.counterfactual,
                     rngs={"sample": jax.random.PRNGKey(0)})
    tdo = {k: torch.tensor(np.asarray(v)) for k, v in jdo.items()}
    with torch.no_grad():
        out = tpgm.counterfactual({k: torch.from_numpy(v) for k, v in obs.items() if k != "x"}, tdo)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5)
    if not do:  # null intervention: exact flow round trip
        for k in ref:
            np.testing.assert_allclose(out[k].numpy(), obs[k], atol=1e-5)


def test_anticausal_logprob_and_predict_match_jax():
    jpgm, params, tpgm, obs, attrs = _pgms(seed=1)
    x = jnp.asarray(obs["x"])
    ref_lp = jpgm.apply({"params": params}, x, method=jpgm.anticausal_logprob, **attrs)
    ref_pred = jpgm.apply({"params": params}, x, method=jpgm.predict, **attrs)
    tattrs = {k: torch.from_numpy(v) for k, v in obs.items() if k != "x"}
    with torch.no_grad():
        lp = tpgm.anticausal_logprob(nchw(obs["x"]), **tattrs)
        pred = tpgm.predict(nchw(obs["x"]), **tattrs)
    for k in ref_lp:
        np.testing.assert_allclose(lp[k].numpy(), np.asarray(ref_lp[k]), atol=1e-5, rtol=1e-5)
    for k in ref_pred:
        np.testing.assert_allclose(pred[k].numpy(), np.asarray(ref_pred[k]), atol=1e-5)


@pytest.mark.parametrize("res", [32, 64])
def test_cnn_norm_epsilon_is_flax(res):
    """Near-constant images put the GroupNorm variance near 1e-6, where flax's
    epsilon (1e-6) and PyTorch's default (1e-5) give different outputs."""
    x = (1e-3 * np.random.default_rng(3).normal(0, 1, (2, res, res, 1))).astype(np.float32)
    jcnn = jm.CNN(input_res=res, width=8, num_outputs=3, context_dim=1)
    y = np.ones((2, 1), np.float32)
    params = jcnn.init(jax.random.PRNGKey(0), jnp.asarray(x), y=jnp.asarray(y))["params"]
    ref = np.asarray(jcnn.apply({"params": params}, jnp.asarray(x), y=jnp.asarray(y)))
    tcnn = tm.CNN(input_res=res, width=8, num_outputs=3, context_dim=1)
    load_jax_params(tcnn, params)
    with torch.no_grad():
        out = tcnn(nchw(x), y=torch.from_numpy(y)).numpy()
        for m in tcnn.modules():
            if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                m.eps = 1e-5
        torch_default = tcnn(nchw(x), y=torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert np.abs(torch_default - ref).max() > 1e-3


@pytest.mark.parametrize("activation", ["gelu", "leaky_relu"])
def test_dense_nn_matches_jax(activation):
    x = np.random.default_rng(4).normal(0, 2, (16, 1)).astype(np.float32)
    jnet = jm.DenseNN(hidden=(32, 32), param_dims=(1, 1), activation=activation)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = jnet.apply({"params": params}, jnp.asarray(x))
    tnet = tm.DenseNN(1, (32, 32), (1, 1), activation=activation)
    load_jax_params(tnet, params)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_sample_scm_draws_when_no_noise_is_given():
    """Without exogenous noise the SCM samples every site from ``generator``:
    flows land in (-1, 1), the digit is one-hot, and a seed repeats."""
    from causal_gen_tpu_torch.pgm.base import sample_scm

    tpgm = _pgms()[2]
    draw = lambda seed: sample_scm(tpgm._nodes(), 64,  # noqa: E731
                                   generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a, b, c = draw(0), draw(0), draw(1)
    for k in ("thickness", "intensity"):
        assert a[k].shape == (64, 1) and torch.all(a[k].abs() < 1)
    assert torch.equal(a["digit"].sum(-1), torch.ones(64))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["thickness"], c["thickness"])
