"""The MIMIC-CXR PGM against the JAX package: ChestPGM's counterfactual under
do(age), do(finding), do(race), do(sex) and no intervention (the finding
restore), infer_exogeneous and sample_scm, with the Gumbel posterior's draws
injected; gumbel_posterior's argmax property; the GroupNorm ResNet-18
predictor (predict, anticausal_logprob) at 64^2 in float32. Parameters load
with strict=True: the PGM holds finding_net and no predictor, the predictor
the trunk and heads and no finding_net, as the JAX checkpoints do.

Tolerance: 1e-5 abs + rel everywhere (the spline's, as in
tests/test_torch_pgm.py). A counterfactual finding is compared on every row
whose two values of g + logits lie more than TIE_GAP apart; rows nearer a
tie could go either way on the two sides and are counted, not compared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from causal_gen_tpu.pgm.flow_pgm import ChestPGM as JChestPGM
from causal_gen_tpu_torch.convert import params_from_jax
from causal_gen_tpu_torch.pgm import base
from causal_gen_tpu_torch.pgm.flow_pgm import ChestPGM

from tests.torch_parity import nchw, patch_jax_gumbel, to_numpy

torch.set_num_threads(1)

N = 16
RES = 64
MIMIC_VARS = ("sex", "age", "race", "finding")
F32_TOL = dict(atol=1e-5, rtol=1e-5)
TIE_GAP = 1e-5


def mimic_obs(seed=0, n=N, res=RES):
    """PGM-space parents: sex and finding 0/1, age in [-0.9, 0.9], race
    one-hot(3); NHWC x in [-1, 1]."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.uniform(-1, 1, (n, res, res, 1)).astype(np.float32),
        "sex": rng.integers(0, 2, (n, 1)).astype(np.float32),
        "age": rng.uniform(-0.9, 0.9, (n, 1)).astype(np.float32),
        "race": np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)],
        "finding": rng.integers(0, 2, (n, 1)).astype(np.float32),
    }


def torch_attrs(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items() if k != "x"}


def load_strict(module, tree):
    module.load_state_dict(params_from_jax(to_numpy(tree)), strict=True)
    return module


def steep_finding_net(r):
    """finding_net parameters under which P(finding = 1 | age) rises from
    ~0.02 at age -0.9 to ~0.98 at 0.9, so that do(age) moves findings (seeded
    nets are flat in age), each leaf jittered by 10% from ``r``: hidden
    sigmoid(8 age), then sigmoid(sum - 4), then logits (0, 8 h - 4)."""
    def jitter(a):
        return (a * (1 + 0.1 * r.standard_normal(a.shape))).astype(np.float32)

    return {
        "Dense_0": {"kernel": jitter(np.full((1, 8), 8.0)), "bias": np.zeros(8, np.float32)},
        "Dense_1": {"kernel": jitter(np.ones((8, 16))), "bias": jitter(np.full(16, -4.0))},
        "Dense_2": {"kernel": jitter(np.stack([np.full(16, 1e-2), np.full(16, 0.5)], 1)),
                    "bias": np.array([0.0, -4.0], np.float32)},
    }


@functools.cache
def pgm_pair(seed=0, setup_predictors=False, res=RES):
    """The JAX ChestPGM, its parameters and the port's holding them. The PGM
    is initialised through svi_logprob, the predictor through
    anticausal_logprob, as cli/train_pgm.py initialises sup_pgm and sup_aux;
    the constant leaves (logits, spline, norms, biases) are made random and
    finding_net steep in age."""
    obs = mimic_obs(seed, res=res)
    attrs = {k: jnp.asarray(v) for k, v in obs.items() if k != "x"}
    key = jax.random.PRNGKey(seed)
    jpgm = JChestPGM(setup_predictors=setup_predictors, input_res=res)
    if setup_predictors:
        params = jpgm.init({"params": key, "sample": key, "dropout": key},
                           jnp.asarray(obs["x"]), method=jpgm.anticausal_logprob, **attrs)
    else:
        params = jpgm.init({"params": key, "sample": key}, attrs)
    r = np.random.default_rng(seed + 100)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + r.normal(0, 0.5, a.shape)).astype(np.float32)
        if np.ptp(np.asarray(a)) == 0 else np.asarray(a), to_numpy(params["params"]))
    if not setup_predictors:
        params["finding_net"] = steep_finding_net(r)
    tpgm = ChestPGM(setup_predictors=setup_predictors, input_res=res, device="cpu")
    load_strict(tpgm, params)
    return jpgm, params, tpgm, obs, attrs


def test_roles_hold_what_the_checkpoints_hold():
    pgm = ChestPGM(setup_predictors=False, device="cpu")
    pred = ChestPGM(setup_predictors=True, device="cpu")
    assert any(k.startswith("finding_net.") for k in pgm.state_dict())
    assert not any(k.startswith(("trunk.", "head_")) for k in pgm.state_dict())
    assert not any(k.startswith("finding_net.") for k in pred.state_dict())
    # the trunk of the flagship's predictor: 11,170,240 parameters
    assert sum(p.numel() for p in pred.trunk.parameters()) == 11_170_240
    assert pgm.sex_logit.item() == pytest.approx(np.log(0.5))
    np.testing.assert_allclose(pgm.race_logits.detach().numpy(), np.log(1 / 3) * np.ones((1, 3)))


@pytest.mark.parametrize("do", [
    {"age": -0.5},          # the finding's parent: the posterior Gumbels decide it
    {"finding": "flip"},
    {"race": [0.0, 0.0, 1.0]},
    {"sex": "flip"},
    {},                     # nothing on age or finding: the observed finding is kept
])
def test_counterfactual_matches_jax(monkeypatch, do):
    jpgm, params, tpgm, obs, attrs = pgm_pair()
    jdo = {}
    for k, v in do.items():
        jdo[k] = (1.0 - attrs[k]) if v == "flip" else (
            jnp.asarray(v, jnp.float32) if k == "race" else jnp.full((N, 1), v))
    rec = patch_jax_gumbel(monkeypatch, seed=7)
    ref = jpgm.apply({"params": params}, attrs, jdo, method=jpgm.counterfactual,
                     rngs={"sample": jax.random.PRNGKey(0)})
    assert [d.shape for d in rec.draws] == [(N, 1), (N, 2)]  # top, rest
    tdo = {k: torch.tensor(np.asarray(v)) for k, v in jdo.items()}
    with torch.no_grad():
        out = tpgm.counterfactual(torch_attrs(obs), tdo, noise=iter(rec.torch_draws()))
    for k in ("sex", "age", "race"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **F32_TOL)
    # the finding on every row not within TIE_GAP of a tie, from the port's g + logits
    with torch.no_grad():
        g = base.gumbel_posterior(tpgm.finding_net(torch_attrs(obs)["age"]),
                                  torch_attrs(obs)["finding"], noise=rec.torch_draws())
        v = g + tpgm.finding_net(out["age"])
    clear = (v[:, 0] - v[:, 1]).abs().numpy() > TIE_GAP
    assert clear.sum() >= N - 1, f"{N - clear.sum()} rows within {TIE_GAP} of a tie"
    np.testing.assert_array_equal(out["finding"].numpy()[clear], np.asarray(ref["finding"])[clear])
    if "age" in do:  # the posterior Gumbels send some findings across
        assert (out["finding"].numpy() != obs["finding"]).any()
    if "age" not in do and "finding" not in do:
        np.testing.assert_array_equal(out["finding"].numpy(), obs["finding"])
    if "finding" in do:
        np.testing.assert_array_equal(out["finding"].numpy(), 1.0 - obs["finding"])
    if "race" in do:
        np.testing.assert_array_equal(out["race"].numpy(), np.tile([[0.0, 0.0, 1.0]], (N, 1)))


def test_infer_exogeneous_and_sample_scm_match_jax(monkeypatch):
    jpgm, params, tpgm, obs, attrs = pgm_pair(seed=1)
    rec = patch_jax_gumbel(monkeypatch, seed=8)
    ref = jpgm.apply({"params": params}, attrs, method=jpgm.infer_exogeneous,
                     rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        out = tpgm.infer_exogeneous(torch_attrs(obs), noise=iter(rec.torch_draws()))
    assert sorted(out) == sorted(ref) == ["age_base", "finding_base"]
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **F32_TOL)
    # the SCM from that noise and the observed roots reproduces the observation
    noise = {**out, "sex": torch_attrs(obs)["sex"], "race": torch_attrs(obs)["race"]}
    with torch.no_grad():
        again = tpgm.sample_scm(N, noise=noise)
    for k in MIMIC_VARS:
        np.testing.assert_allclose(again[k].numpy(), obs[k], err_msg=k, **F32_TOL)
    # with nothing observed every site is drawn: the finding a class index
    with torch.no_grad():
        draws = tpgm.sample_scm(64, generator=torch.Generator().manual_seed(0))
    assert set(np.unique(draws["finding"].numpy())) <= {0.0, 1.0}
    assert draws["race"].shape == (64, 3) and (draws["race"].sum(-1) == 1).all()


def test_gumbel_posterior_draws_from_the_generator_on_its_device():
    """Without injected draws the two Gumbels come from the CPU generator
    (drawn there, then moved), so the same seed gives the same draws."""
    logits = torch.tensor([[0.3, -1.2], [2.0, 0.5]])
    k = torch.tensor([[1.0], [0.0]])
    a = base.gumbel_posterior(logits, k, torch.Generator().manual_seed(3))
    b = base.gumbel_posterior(logits, k, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), k=st.integers(2, 6),
       spread=st.floats(0.0, 30.0, allow_nan=False))
def test_gumbel_posterior_keeps_the_observed_argmax(seed, k, spread):
    """argmax(g + logits) == k_obs on every row; a row may only miss where
    its top two values of g + logits are within 4 float32 ulps of each other,
    a tie that float32 cannot tell apart."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy((rng.standard_normal((64, k)) * spread).astype(np.float32))
    k_obs = torch.from_numpy(rng.integers(0, k, (64, 1)).astype(np.float32))
    g = base.gumbel_posterior(logits, k_obs, torch.Generator().manual_seed(seed))
    v = g + logits
    hit = torch.argmax(v, dim=-1) == k_obs[:, 0].long()
    top = v.max(dim=-1).values
    at_k = v.gather(1, k_obs.long())[:, 0]
    ulp = torch.finfo(torch.float32).eps * top.abs().clamp(min=1.0)
    assert (hit | (top - at_k <= 4 * ulp)).all()


def test_predictor_matches_jax():
    """predict and anticausal_logprob with the ResNet-18 trunk at 64^2: the
    7x7 stride-2 stem, the -inf-padded 3x3 max-pool, eight GroupNorm blocks
    (dropout off), the mean pool and the four heads."""
    jpgm, params, tpgm, obs, attrs = pgm_pair(seed=2, setup_predictors=True)
    x = jnp.asarray(obs["x"])
    ref_lp = jpgm.apply({"params": params}, x, method=jpgm.anticausal_logprob, **attrs)
    ref_pred = jpgm.apply({"params": params}, x, method=jpgm.predict, **attrs)
    with torch.no_grad():
        lp = tpgm.anticausal_logprob(nchw(obs["x"]), **torch_attrs(obs))
        pred = tpgm.predict(nchw(obs["x"]), **torch_attrs(obs))
    assert sorted(lp) == sorted(ref_lp) and sorted(pred) == sorted(ref_pred)
    for k in ref_lp:
        np.testing.assert_allclose(lp[k].numpy(), np.asarray(ref_lp[k]), err_msg=k, **F32_TOL)
    for k in ref_pred:
        np.testing.assert_allclose(pred[k].numpy(), np.asarray(ref_pred[k]), err_msg=k,
                                   **F32_TOL)
