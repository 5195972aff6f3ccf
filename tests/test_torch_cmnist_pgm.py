"""The Colour-MNIST SCM (``ColourMNISTPGM``: digit and colour, two
categorical roots, and the width-8 CNN predictors on RGB) against the JAX
package's: anticausal log-probs and predictions, the counterfactual under
do(colour) and do(digit); the committed ``sup_pgm_cmnist/cmnist_pgm`` and
``sup_aux_cmnist/cmnist_aux`` trees loaded with ``strict=True`` (their
configs say ``input_channels`` 1, the CLI's default; the predictors read
RGB, as the JAX CNN takes its input's channels) and held against JAX on a
seeded batch; and the Colour-MNIST DSCM (``cmnist/final_cmnist`` +
``cmnist_pgm`` + ``cmnist_aux``) at bs 1 under do(colour) through
``flagship_forward_check`` (float32: the parents 1e-5, ELBO terms and the
predictor's loss 1e-4 rel, cf_x 1e-4 abs).

Tolerances elsewhere: 1e-5 abs + rel (float32, the same formulas)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu_torch.convert import build_pgm, checkpoint_meta, params_from_jax
from causal_gen_tpu_torch.pgm.flow_pgm import PGM_REGISTRY, ColourMNISTPGM

from tests.torch_parity import flagship_forward_check, flax_checkpoint_numpy, nchw, pgm_pair
from tests.torch_parity import synth_pgm_obs

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
PGM_PATH = "checkpoints/sup_pgm_cmnist/cmnist_pgm/checkpoint"
AUX_PATH = "checkpoints/sup_aux_cmnist/cmnist_aux/checkpoint"
DSCM_PATHS = ("checkpoints/cmnist/final_cmnist/checkpoint", PGM_PATH, AUX_PATH)


def _t(obs):
    return {k: nchw(v) if k == "x" else torch.from_numpy(v) for k, v in obs.items()}


def test_registry_cmnist_is_the_committed_hvaes_configuration():
    """chip_smoke.py's cmnist_cf phase runs the registry's cmnist (the card
    gets no checkpoint): it is final_cmnist's HVAE, field for field."""
    import json

    from causal_gen_tpu_torch.config import get_config

    with open("checkpoints/cmnist/final_cmnist/hparams.json") as f:
        hp = json.load(f)
    cfg = get_config("cmnist")
    for k in ("enc_arch", "dec_arch", "widths", "bottleneck", "z_dim", "z_max_res",
              "bias_max_res", "x_like", "std_init", "parents_x", "context_dim", "input_res",
              "input_channels", "cond_prior", "q_correction", "block_version", "dtype"):
        got = getattr(cfg, k)
        assert (list(got) if isinstance(got, tuple) else got) == hp[k], k


def test_registry_and_roles():
    assert PGM_REGISTRY["cmnist"] is ColourMNISTPGM
    pgm = ColourMNISTPGM(setup_predictors=False, device="cpu")
    assert sorted(pgm.state_dict()) == ["colour_logits", "digit_logits"]
    pred = ColourMNISTPGM(device="cpu")
    assert pred.encoder_y.Conv_0.weight.shape == (8, 3, 7, 7)


def test_anticausal_logprob_and_predict_match_jax():
    jpgm, tree, tpgm, obs = pgm_pair("cmnist", "aux", seed=1)
    attrs = {k: jnp.asarray(v) for k, v in obs.items() if k != "x"}
    x = jnp.asarray(obs["x"])
    t = _t(obs)
    with torch.no_grad():
        lp = tpgm.anticausal_logprob(t.pop("x"), **t)
        pred = tpgm.predict(nchw(obs["x"]))
    ref_lp = jpgm.apply({"params": tree}, x, method=jpgm.anticausal_logprob, **attrs)
    ref_pred = jpgm.apply({"params": tree}, x, method=jpgm.predict, **attrs)
    for got, ref in ((lp, ref_lp), (pred, ref_pred)):
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("site", ["colour", "digit"])
def test_counterfactual_matches_jax(site):
    """A root with no flow keeps its observed value unless intervened on:
    do(site) sets that site and leaves the other."""
    jpgm, tree, tpgm, obs = pgm_pair("cmnist", "pgm", seed=2)
    attrs = {k: v for k, v in obs.items() if k != "x"}
    do = np.eye(10, dtype=np.float32)[np.arange(len(attrs[site])) % 10]
    ref = jpgm.apply({"params": tree}, {k: jnp.asarray(v) for k, v in attrs.items()},
                     {site: jnp.asarray(do)}, method=jpgm.counterfactual,
                     rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = tpgm.counterfactual({k: torch.from_numpy(v) for k, v in attrs.items()},
                                  {site: torch.from_numpy(do)})
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)
    other = "digit" if site == "colour" else "colour"
    np.testing.assert_array_equal(got[site].numpy(), do)
    np.testing.assert_array_equal(got[other].numpy(), attrs[other])


@pytest.mark.parametrize("path,predictors", [(PGM_PATH, False), (AUX_PATH, True)])
def test_committed_trees_load_strictly_and_match_jax(path, predictors):
    from causal_gen_tpu.cli.train_cf import build_pgm_from_ckpt

    cfg = checkpoint_meta(path)["config"]
    assert cfg["input_channels"] == 1  # the CLI's default, not the images' channels
    tree = flax_checkpoint_numpy(path, "pgm")
    tpgm = build_pgm(cfg, predictors, "cpu")
    tpgm.load_state_dict(params_from_jax(tree), strict=True)
    _, jpgm, _ = build_pgm_from_ckpt(path, predictors)
    obs = synth_pgm_obs("cmnist", 4, 32, seed=3)
    attrs = {k: v for k, v in obs.items() if k != "x"}
    ref = jpgm.apply({"params": tree}, {k: jnp.asarray(v) for k, v in attrs.items()},
                     method=jpgm.svi_logprob)
    with torch.no_grad():
        got = tpgm.svi_logprob({k: torch.from_numpy(v) for k, v in attrs.items()})
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)
    if predictors:
        ref = jpgm.apply({"params": tree}, jnp.asarray(obs["x"]),
                         method=jpgm.anticausal_logprob,
                         **{k: jnp.asarray(v) for k, v in attrs.items()})
        with torch.no_grad():
            got = tpgm.anticausal_logprob(nchw(obs["x"]),
                                          **{k: torch.from_numpy(v) for k, v in attrs.items()})
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4,
                                       rtol=1e-5, err_msg=k)


def test_cmnist_dscm_forward_matches_jax(monkeypatch):
    """The committed Colour-MNIST DSCM at bs 1 under do(colour): an RGB
    digit image (a ring of one colour on black), its digit and colour."""
    yy, xx = np.mgrid[:32, :32]
    ring = (np.abs(np.hypot(yy - 15.5, xx - 15.5) - 8) < 2.5).astype(np.float32)
    colour = np.array([0.9, 0.3, 0.1], np.float32)
    x = (ring[..., None] * colour * 2 - 1)[None].astype(np.float32)
    obs = {"x": x, "digit": np.eye(10, dtype=np.float32)[[0]],
           "colour": np.eye(10, dtype=np.float32)[[2]]}
    do = {"colour": np.eye(10, dtype=np.float32)[[7]]}
    flagship_forward_check(monkeypatch, DSCM_PATHS, "float32", obs, do)
