"""The UK Biobank PGM, its nets and data against the JAX package: the
FlowPGM (counterfactual with a binary root observed or intervened,
infer_exogeneous, sample_scm, anticausal_logprob, predict, guide_sample with
its draws injected), MLP, the Bernoulli ops, the UKBB reader on a CSV + PNG
tree written here (every context_norm, the augmentation spec), and cli.main
taking two steps of the ukbb192 config (bf16, reduced depth and width) on
that tree on the CPU.

Tolerance: 1e-5 abs + rel everywhere (the spline's logdet too, as in
tests/test_torch_pgm.py: XLA's cumsum rounds the knots one ulp apart); the
reader's images and attributes exactly.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.config import get_config as jget
from causal_gen_tpu.ops import distributions as jd
from causal_gen_tpu.pgm import modules as jm
from causal_gen_tpu.pgm.flow_pgm import FlowPGM as JFlowPGM
from causal_gen_tpu_torch.config import get_config as tget
from causal_gen_tpu_torch.ops import distributions as td
from causal_gen_tpu_torch.pgm import modules as tm
from causal_gen_tpu_torch.pgm.flow_pgm import FlowPGM

from tests.torch_parity import load_jax_params, nchw, to_numpy

torch.set_num_threads(1)

RES = 32
N = 4
PGM_VARS = ("sex", "mri_seq", "age", "brain_volume", "ventricle_volume")
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# the reduced ukbb192 architecture of tests/test_torch_ukbb.py
ARCH = dict(input_res=RES, enc_arch="32b1d2,16b2d2,8b2d4,2b1d2,1b1",
            dec_arch="1b1,2b2,8b2,16b2,32b1", widths=(8, 8, 16, 16, 32), z_dim=4,
            z_max_res=16, bias_max_res=8)


def ukbb_obs(seed=0, n=N):
    """PGM-space parents: binary 0/1, continuous in [-0.8, 0.8]; NHWC x."""
    rng = np.random.default_rng(seed)
    obs = {"x": rng.uniform(-1, 1, (n, RES, RES, 1)).astype(np.float32)}
    for k in PGM_VARS:
        obs[k] = (rng.integers(0, 2, (n, 1)) if k in ("sex", "mri_seq")
                  else rng.uniform(-0.8, 0.8, (n, 1))).astype(np.float32)
    return obs


@functools.cache
def pgm_pair(seed=0, setup_predictors=True):
    """The JAX FlowPGM, its parameters (spline and logits made random), the
    port's FlowPGM holding them, and a batch; cached per argument."""
    obs = ukbb_obs(seed)
    attrs = {k: jnp.asarray(v) for k, v in obs.items() if k != "x"}
    key = jax.random.PRNGKey(seed)
    jpgm = JFlowPGM(setup_predictors=setup_predictors, input_res=RES)
    params = to_numpy(jpgm.init({"params": key, "sample": key},
                                jnp.asarray(obs["x"]) if setup_predictors else None, attrs,
                                method=jpgm.init_all)["params"])
    r = np.random.default_rng(seed + 100)
    for k in ("s_logit", "m_logit", "age_widths", "age_heights", "age_derivs", "age_lambdas"):
        params[k] = r.normal(0, 1, params[k].shape).astype(np.float32)
    tpgm = FlowPGM(setup_predictors=setup_predictors, input_res=RES, device="cpu")
    load_jax_params(tpgm, params)
    return jpgm, params, tpgm, obs, attrs


def torch_attrs(d):
    """The non-image entries of ``d`` as float32 tensors."""
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items() if k != "x"}


@pytest.mark.parametrize("do", [
    {"sex": "flip"},           # a binary root intervened
    {"age": 0.5},
    {"brain_volume": -0.3},
    {"ventricle_volume": 0.2, "mri_seq": 1.0},
    {},                        # null intervention: exact round trip
])
def test_pgm_counterfactual_matches_jax(do):
    """Binary roots not intervened on keep their observed values."""
    jpgm, params, tpgm, obs, attrs = pgm_pair(setup_predictors=False)
    jdo = {k: (1.0 - attrs["sex"]) if v == "flip" else jnp.full((N, 1), v)
           for k, v in do.items()}
    ref = jpgm.apply({"params": params}, attrs, jdo, method=jpgm.counterfactual,
                     rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        out = tpgm.counterfactual(torch_attrs(obs), torch_attrs(jdo))
    for k in PGM_VARS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **F32_TOL)
    for k in ("sex", "mri_seq"):
        want = np.asarray(jdo[k]) if k in jdo else obs[k]
        np.testing.assert_array_equal(out[k].numpy(), want)
    if not do:
        for k in PGM_VARS:
            np.testing.assert_allclose(out[k].numpy(), obs[k], err_msg=k, **F32_TOL)


def test_pgm_infer_exogeneous_and_sample_scm_match_jax():
    jpgm, params, tpgm, obs, attrs = pgm_pair(seed=1, setup_predictors=False)
    ref = jpgm.apply({"params": params}, attrs, method=jpgm.infer_exogeneous,
                     rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        out = tpgm.infer_exogeneous(torch_attrs(obs))
    assert sorted(out) == sorted(ref) == ["age_base", "brain_volume_base",
                                          "ventricle_volume_base"]
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **F32_TOL)
    # the SCM from that noise and the observed roots reproduces the observation
    noise = {**{k: v for k, v in out.items()}, "sex": torch_attrs(obs)["sex"],
             "mri_seq": torch_attrs(obs)["mri_seq"]}
    with torch.no_grad():
        again = tpgm.sample_scm(N, noise=noise)
    for k in PGM_VARS:
        np.testing.assert_allclose(again[k].numpy(), obs[k], err_msg=k, **F32_TOL)
    # unobserved binary roots are drawn: 0/1 at about sigmoid(logit)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        draws = tpgm.sample_scm(4000, generator=g)
    p = torch.sigmoid(tpgm.s_logit).item()
    assert set(np.unique(draws["sex"].numpy())) <= {0.0, 1.0}
    assert abs(draws["sex"].mean().item() - p) < 4 * np.sqrt(p * (1 - p) / 4000)


def test_pgm_predictors_match_jax(monkeypatch):
    """anticausal_logprob and predict at the observed values; guide_sample
    with every site unobserved, its draws injected."""
    jpgm, params, tpgm, obs, attrs = pgm_pair(seed=2)
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

    rng = np.random.default_rng(3)
    draws = []

    def record(kind):
        def fn(key, shape=(), dtype=jnp.float32, *a, **k):
            v = (rng.uniform(0, 1, shape) if kind == "u" else rng.standard_normal(shape))
            draws.append(v.astype(np.float32))
            return jnp.asarray(draws[-1], dtype)
        return fn

    monkeypatch.setattr(jax.random, "uniform", record("u"))
    monkeypatch.setattr(jax.random, "normal", record("n"))
    empty = {k: None for k in PGM_VARS}
    jvals, jlogq = jpgm.apply({"params": params}, x, empty, method=jpgm.guide_sample,
                              rngs={"sample": jax.random.PRNGKey(1)})
    order = ("mri_seq", "ventricle_volume", "brain_volume", "sex", "age")
    noise = {k: torch.from_numpy(d) for k, d in zip(order, draws)}
    with torch.no_grad():
        vals, logq = tpgm.guide_sample(nchw(obs["x"]), dict(empty), noise=noise)
    for k in order:
        np.testing.assert_allclose(vals[k].numpy(), np.asarray(jvals[k]), err_msg=k, **F32_TOL)
        np.testing.assert_allclose(logq[k].numpy(), np.asarray(jlogq[k]), err_msg=k, **F32_TOL)


def test_mlp_and_bernoulli_ops_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 2)).astype(np.float32)
    jmlp = jm.MLP(num_outputs=2)
    params = jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 16))
    params = jax.tree.map(lambda a: a + 0.3 * jax.random.normal(next(keys), a.shape), params)
    tmlp = tm.MLP(2, num_outputs=2)
    load_jax_params(tmlp, params)
    with torch.no_grad():
        out = tmlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jmlp.apply({"params": params}, jnp.asarray(x))),
                               **F32_TOL)

    logits = rng.normal(0, 3, (50, 1)).astype(np.float32)
    xb = rng.integers(0, 2, (50, 1)).astype(np.float32)
    probs = np.concatenate([[[0.0], [1.0], [1e-9]], rng.uniform(0, 1, (47, 1))]).astype(np.float32)
    np.testing.assert_allclose(
        td.bernoulli_logpmf_logits(torch.from_numpy(xb), torch.from_numpy(logits)).numpy(),
        np.asarray(jd.bernoulli_logpmf_logits(jnp.asarray(xb), jnp.asarray(logits))), **F32_TOL)
    np.testing.assert_allclose(
        td.bernoulli_logpmf_probs(torch.from_numpy(xb), torch.from_numpy(probs)).numpy(),
        np.asarray(jd.bernoulli_logpmf_probs(jnp.asarray(xb), jnp.asarray(probs))), **F32_TOL)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jd.sample_bernoulli(key, jnp.asarray(logits)))
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, logits.shape)))
    np.testing.assert_array_equal(td.sample_bernoulli(torch.from_numpy(logits), u=u).numpy(), ref)
    g = torch.Generator().manual_seed(0)
    draws = td.sample_bernoulli(torch.full((1, 1), 0.4), (20000, 1), generator=g)
    p = 1 / (1 + np.exp(-0.4))
    assert draws.shape == (20000, 1) and abs(draws.mean().item() - p) < 4 * np.sqrt(p * (1 - p) / 2e4)


# ---------------------------------------------------------------------------
# the UKBB reader and the CLI on a tree written here
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ukbb_tree(tmp_path_factory):
    from tools.e2e_synth import make_ukbb_tree

    root = str(tmp_path_factory.mktemp("ukbb"))
    make_ukbb_tree(root, n_per_split=6, seed=0)
    return root


@pytest.mark.parametrize("context_norm", ["[-1,1]", "[0,1]", "log_standard", "raw"])
def test_ukbb_reader_matches_jax(ukbb_tree, context_norm):
    from causal_gen_tpu.data.datasets import setup_datasets as jsetup
    from causal_gen_tpu_torch.data.datasets import setup_datasets as tsetup

    kw = dict(input_res=RES, context_norm=context_norm,
              parents_x=("mri_seq", "brain_volume", "ventricle_volume", "sex", "age"))
    ref, got = jsetup(jget("ukbb192", **kw), ukbb_tree), tsetup(tget("ukbb192", **kw), ukbb_tree)
    assert sorted(ref) == sorted(got) == ["test", "train", "valid"]
    for split in ref:
        r, g = ref[split], got[split]
        assert g.images.dtype == np.uint8 and g.images.shape == (6, RES, RES, 1)
        np.testing.assert_array_equal(g.images, r.images)
        assert g.columns == tuple(r.columns)
        for k in kw["parents_x"]:
            assert g.attrs[k].dtype == np.float32
            np.testing.assert_array_equal(g.attrs[k], np.asarray(r.attrs[k], np.float32), k)
        np.testing.assert_array_equal(g.pa, r.pa)
        assert g.aug == r.aug
    cfg = tget("ukbb192")
    assert got["train"].aug == ("random_crop_flip", (RES, RES), (cfg.pad, 2 * cfg.pad), cfg.hflip)


def test_cli_main_trains_ukbb192_on_cpu(ukbb_tree, tmp_path):
    from causal_gen_tpu_torch.cli import main as cli

    argv = ["--hps", "ukbb192", "--device", "cpu", "--data_dir", ukbb_tree,
            "--save_dir", str(tmp_path), "--epochs", "1", "--eval_freq", "1",
            "--max_batches", "2", "--bs", "2"]
    for k, v in ARCH.items():
        argv += [f"--{k}", *map(str, v)] if isinstance(v, tuple) else [f"--{k}", str(v)]
    state, history = cli.main(argv)
    assert state.step + state.skipped == 2
    assert state.model.cfg.dtype == "bfloat16"
    assert all(np.isfinite(history[k]) for k in ("train_elbo", "valid_elbo"))
    assert os.path.exists(os.path.join(str(tmp_path), "checkpoint.meta.json"))
