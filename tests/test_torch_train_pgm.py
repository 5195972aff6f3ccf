"""PGM and predictor training (``pgm/train_pgm.py``, ``cli/train_pgm.py``)
against the JAX package's (causal_gen_tpu/pgm/train_pgm.py): three updates
of ``sup_pgm``, ``sup_aux`` and ``semi_sup`` from the same parameters,
batches and guide draws (losses, site log-probs, gradient norms, parameters
and EMA); the guide's draws (``guide_sample``) and the predictors' metrics
(``utils/metrics.py``, ``pgm_eval_metrics``); the committed PGM trees
(``long_pgm``, ``semisup_morpho``, ``semi_sup_mimic``,
``semi_sup_ukbb/semisup_ukbb``) converted and loaded with ``strict=True``,
their log-probs and guide against JAX on a seeded batch; and
``cli.train_pgm --device cpu`` for every setup.

Tolerances: losses, site log-probs and gradient norms 1e-4 rel; parameters
and EMA after three updates within 2 lr per update, 6 lr: AdamW moves an
element by at most lr an update, and where a gradient element is a sum
that cancels to near its rounding its sign may differ between the two
packages (the JAX steps run jitted, the port's eagerly). The semi_sup
steps after the first start from parameters that differ so (by ~lr in the
mri_seq predictor's last conv of the UK Biobank PGM, whose gradient comes
through the score-function term alone): their metrics are held at 1e-3
rel, the first step's at 1e-4. Log-probs and guide values 1e-5 abs + rel
(float32, the same formulas). The guide's draws reach the JAX step through
patched ``jax.random.normal`` / ``uniform`` / ``categorical`` (the step is
jitted, so they are drawn once, at trace time, and serve every update) and
the port as ``draws``."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.utils import metrics as jmetrics
from causal_gen_tpu_torch.convert import build_pgm, params_from_jax
from causal_gen_tpu_torch.pgm import train_pgm as ttp
from causal_gen_tpu_torch.utils import metrics as tmetrics

from tests.torch_parity import flax_checkpoint_numpy, nchw, patch_jax_draws, pgm_pair
from tests.torch_parity import synth_pgm_obs, to_numpy

# the JAX package's pgm/__init__.py exports a function of the module's name
jtp = importlib.import_module("causal_gen_tpu.pgm.train_pgm")
torch.set_num_threads(2)

N = 6
LR = 1e-3
# the guide's sites in draw order, with the kind of draw each takes
GUIDE_ORDER = {
    "morphomnist": (("intensity", "normal"), ("thickness", "normal"), ("digit", "categorical")),
    "cmnist": (("digit", "categorical"), ("colour", "categorical")),
    "ukbb": (("mri_seq", "uniform"), ("ventricle_volume", "normal"),
             ("brain_volume", "normal"), ("sex", "uniform"), ("age", "normal")),
    "mimic": (("sex", "uniform"), ("race", "categorical"), ("finding", "uniform"),
              ("age", "normal")),
}


def patch_guide_draws(monkeypatch, seed):
    """The draws of a JAX guide (normals, uniforms, categoricals' Gumbels),
    recorded (``tests/torch_parity.py::JaxDraws``)."""
    return patch_jax_draws(monkeypatch, seed, "normal", "uniform", "categorical")


def by_site(rec, dataset, sites=None):
    """The recorded draws as the port's guide takes them, {site: draw}."""
    order = GUIDE_ORDER[dataset] if sites is None else sites
    return {site: torch.from_numpy(d) for (site, _), d in zip(order, rec.draws)}


def _cfgs(dataset, setup, **kw):
    over = dict(dataset=dataset, setup=setup, lr=LR, bs=N, input_res=32, **kw)
    return jtp.PGMConfig(**over), ttp.PGMConfig(**over)


def _raw_batch(dataset, seed, n=N):
    """A loader batch (concat_pa=False): uint8 NHWC x and the parents; UK
    Biobank's continuous parents in raw units (the batch preprocessing maps
    them to [-1, 1])."""
    from causal_gen_tpu_torch.utils.normalization import get_attr_max_min

    obs = synth_pgm_obs(dataset, n, 32, seed)
    obs["x"] = np.round((obs["x"] + 1) * 127.5).astype(np.uint8)
    if dataset == "ukbb":
        for k in ("age", "brain_volume", "ventricle_volume"):
            hi, lo = get_attr_max_min(k)
            obs[k] = ((obs[k] + 1) / 2 * (hi - lo) + lo).astype(np.float32)
    return obs


def _states(dataset, setup, role, seed=0):
    jcfg, tcfg = _cfgs(dataset, setup)
    jpgm, tree, tpgm, _ = pgm_pair(dataset, role, seed=seed)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jtp.PGMTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               ema_params=jax.tree_util.tree_map(jnp.copy, params),
                               opt_state=jtp.make_pgm_optimizer(jcfg).init(params))
    return jcfg, tcfg, jpgm, jstate, tpgm, ttp.init_pgm_state(tcfg, tpgm)


def _assert_params_close(jstate, tstate, n_updates):
    bound = 2 * LR * n_updates + 1e-6
    assert tstate.step == int(jstate.step) == n_updates
    for tree, module in ((jstate.params, tstate.model), (jstate.ema_params, tstate.ema)):
        ref = params_from_jax(to_numpy(tree))
        got = module.state_dict()
        assert set(ref) <= set(got)
        err = {k: (got[k] - ref[k]).abs().max().item() for k in ref}
        worst = max(err, key=err.get)
        assert err[worst] <= bound, (worst, err[worst], bound)


def _assert_metrics_close(jm, tm, keys, rtol=1e-4):
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dataset,setup", [
    ("morphomnist", "sup_pgm"), ("ukbb", "sup_pgm"), ("mimic", "sup_pgm"), ("cmnist", "sup_pgm"),
    ("morphomnist", "sup_aux"), ("ukbb", "sup_aux"), ("cmnist", "sup_aux"),
])
def test_supervised_steps_match_jax(dataset, setup):
    """Three sup_pgm / sup_aux updates. (ChestPGM's sup_aux step runs its
    trunk's dropout, whose masks the two packages draw apart; its predictor
    is held through semi_sup and the real-weight tests.)"""
    role = "pgm" if setup == "sup_pgm" else "aux"
    jcfg, tcfg, jpgm, jstate, tpgm, tstate = _states(dataset, setup, role)
    jstep = jtp.make_pgm_train_step(jcfg, jpgm, donate=False)
    for s in range(3):
        raw = _raw_batch(dataset, 10 + s)
        jstate, jm = jstep(jstate, jtp.preprocess_pgm_batch(jcfg, raw), jax.random.PRNGKey(s))
        tm = ttp.train_step(tcfg, tstate, ttp.preprocess_pgm_batch(tcfg, raw, "cpu"))
        assert sorted(tm) == sorted(jm)
        _assert_metrics_close(jm, tm, jm)
    _assert_params_close(jstate, tstate, 3)


@pytest.mark.parametrize("dataset", ["morphomnist", "ukbb", "mimic", "cmnist"])
def test_semi_sup_steps_match_jax(monkeypatch, dataset):
    """Three semi_sup updates given the same guide draws: the pathwise
    gradients of the continuous sites and the score-function surrogate of
    the discrete ones (ChestPGM: binary sex and finding, categorical race)."""
    jcfg, tcfg, jpgm, jstate, tpgm, tstate = _states(dataset, "semi_sup", "semi", seed=3)
    rec = patch_guide_draws(monkeypatch, 4)
    n_l = 50
    jstep = jtp.make_semi_sup_train_step(jcfg, jpgm, n_labelled=n_l, donate=False)
    for s in range(3):
        raw_l, raw_u = _raw_batch(dataset, 20 + s), _raw_batch(dataset, 30 + s)
        jstate, jm = jstep(jstate, jtp.preprocess_pgm_batch(jcfg, raw_l),
                           jtp.preprocess_pgm_batch(jcfg, raw_u), jax.random.PRNGKey(s))
        assert len(rec.draws) == len(GUIDE_ORDER[dataset])  # one trace
        tm = ttp.semi_sup_step(tcfg, tstate, ttp.preprocess_pgm_batch(tcfg, raw_l, "cpu"),
                               ttp.preprocess_pgm_batch(tcfg, raw_u, "cpu"), n_l,
                               draws=by_site(rec, dataset))
        _assert_metrics_close(jm, tm, ("loss", "grad_norm", "loss_l", "loss_u", "aux_loss"),
                              rtol=1e-4 if s == 0 else 1e-3)
    _assert_params_close(jstate, tstate, 3)


@pytest.mark.parametrize("dataset", ["morphomnist", "mimic", "cmnist"])
def test_guide_sample_matches_jax(monkeypatch, dataset):
    """The guide's values and log q of every site, all unobserved, and with
    the first site observed."""
    jpgm, tree, tpgm, obs = pgm_pair(dataset, "aux" if dataset != "mimic" else "semi", seed=5)
    x = obs["x"]
    sites = [s for s, _ in GUIDE_ORDER[dataset]]
    for given in ((), sites[:1]):
        rec = patch_guide_draws(monkeypatch, 6)
        part = {k: (jnp.asarray(obs[k]) if k in given else None) for k in tpgm.dag_variables}
        jv, jq = jpgm.apply({"params": tree}, jnp.asarray(x), part, method=jpgm.guide_sample,
                            rngs={"sample": jax.random.PRNGKey(0)})
        order = [s for s in GUIDE_ORDER[dataset] if s[0] not in given]
        draws = by_site(rec, dataset, order)
        tpart = {k: (torch.from_numpy(obs[k]) if k in given else None)
                 for k in tpgm.dag_variables}
        with torch.no_grad():
            tv, tq = tpgm.guide_sample(nchw(x), tpart, noise=draws)
        assert sorted(tq) == sorted(jq) == sorted(s for s, _ in order)
        for k in jv:
            np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), atol=1e-5, rtol=1e-5)
        for k in jq:
            np.testing.assert_allclose(tq[k].numpy(), np.asarray(jq[k]), atol=1e-5, rtol=1e-5)


def test_metrics_match_jax():
    """The port's copy of utils/metrics.py on scores with ties, a class
    missing, and one-hot targets."""
    rng = np.random.default_rng(0)
    t = rng.integers(0, 2, 200)
    s = np.round(rng.uniform(0, 1, 200), 1)  # ties
    onehot = np.eye(4)[rng.integers(0, 3, 200)]  # class 3 never present
    probs = rng.dirichlet(np.ones(4), 200)
    cont = rng.normal(0, 1, (200, 1))
    for name, args in (("roc_auc_binary", (t, s)), ("roc_auc_binary", (np.zeros(5), s[:5])),
                       ("roc_auc_ovr_macro", (onehot, probs)),
                       ("accuracy_binary", (t, s)), ("accuracy_onehot", (onehot, probs)),
                       ("mae", (cont, cont[::-1]))):
        got, ref = getattr(tmetrics, name)(*args), getattr(jmetrics, name)(*args)
        assert (np.isnan(got) and np.isnan(ref)) or got == pytest.approx(ref, rel=1e-12), name


def _datasets(dataset, n, seed, lib):
    """In-memory datasets (train/valid) of a dataset's attributes, raw units
    for UK Biobank, with the JAX package's or the port's ArrayDataset."""
    obs = _raw_batch(dataset, seed, n)
    x = obs.pop("x")
    attrs = {k: (v[:, 0] if v.shape[1] == 1 else v) for k, v in obs.items()}
    return lib.ArrayDataset(images=x, attrs=attrs, columns=tuple(attrs))


@pytest.mark.parametrize("dataset", ["morphomnist", "ukbb", "mimic", "cmnist"])
def test_pgm_eval_metrics_match_jax(dataset):
    """pgm_eval_metrics of the same predictors over the same unshuffled
    batches, with the same unnormalisations."""
    from causal_gen_tpu.data import datasets as jds
    from causal_gen_tpu.data.loader import Loader as JLoader
    from causal_gen_tpu_torch.data import datasets as tds
    from causal_gen_tpu_torch.data.loader import Loader

    jcfg, tcfg = _cfgs(dataset, "sup_aux")
    jpgm, tree, tpgm, _ = pgm_pair(dataset, "aux" if dataset != "mimic" else "semi", seed=7)
    jl = JLoader(_datasets(dataset, 24, 8, jds), 8, shuffle=False, drop_last=False,
                 concat_pa=False)
    tl = Loader(_datasets(dataset, 24, 8, tds), 8, shuffle=False, drop_last=False,
                concat_pa=False)
    ref = jtp.pgm_eval_metrics(jcfg, jpgm, tree, jl)
    got = ttp.pgm_eval_metrics(tcfg, tpgm, tl, "cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-6, nan_ok=True), k


# ---------------------------------------------------------------------------
# The committed PGM trees
# ---------------------------------------------------------------------------

TREES = {
    "long_pgm": "checkpoints/long_pgm/checkpoint",
    "semisup_morpho": "checkpoints/semisup_morpho/checkpoint",
    "semi_sup_mimic": "checkpoints/semi_sup_mimic/checkpoint",
    "semisup_ukbb": "checkpoints/semi_sup_ukbb/semisup_ukbb/checkpoint",
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_committed_pgm_trees_load_strictly_and_match_jax(monkeypatch, name):
    """The EMA tree of each committed checkpoint through ``convert`` into the
    module ``build_pgm`` makes from its config, with ``strict=True`` (in
    both roles for a semi_sup tree); then on a seeded batch its
    svi_logprob, and where it has predictors anticausal_logprob and the
    guide (given the draws), against the flax module on the same tree."""
    from causal_gen_tpu.cli.train_cf import build_pgm_from_ckpt
    from causal_gen_tpu_torch.convert import checkpoint_meta

    path = TREES[name]
    cfg = checkpoint_meta(path)["config"]
    tree = flax_checkpoint_numpy(path, "pgm")
    predictors = cfg["setup"] != "sup_pgm"
    for role in (False, True) if cfg["setup"] == "semi_sup" else (predictors,):
        tpgm = build_pgm(cfg, role, "cpu")
        tpgm.load_state_dict(params_from_jax(tree), strict=True)
    _, jpgm, _ = build_pgm_from_ckpt(path, predictors)
    dataset = cfg["dataset"]
    obs = synth_pgm_obs(dataset, 4, cfg["input_res"], seed=9)
    attrs = {k: v for k, v in obs.items() if k != "x"}
    ref = jpgm.apply({"params": tree}, {k: jnp.asarray(v) for k, v in attrs.items()},
                     method=jpgm.svi_logprob)
    with torch.no_grad():
        got = tpgm.svi_logprob({k: torch.from_numpy(v) for k, v in attrs.items()})
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=1e-5)
    if not predictors:
        return
    x = jnp.asarray(obs["x"])
    ref = jpgm.apply({"params": tree}, x, method=jpgm.anticausal_logprob,
                     **{k: jnp.asarray(v) for k, v in attrs.items()})
    with torch.no_grad():
        got = tpgm.anticausal_logprob(nchw(obs["x"]),
                                      **{k: torch.from_numpy(v) for k, v in attrs.items()})
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=1e-5,
                                   err_msg=k)
    rec = patch_guide_draws(monkeypatch, 10)
    empty = {k: None for k in tpgm.dag_variables}
    jv, jq = jpgm.apply({"params": tree}, x, empty, method=jpgm.guide_sample,
                        rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        tv, tq = tpgm.guide_sample(nchw(obs["x"]), dict(empty), noise=by_site(rec, dataset))
    for k in jq:
        np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(tq[k].numpy(), np.asarray(jq[k]), atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("setup", ["sup_pgm", "sup_aux", "semi_sup"])
def test_cli_train_pgm_runs_every_setup(tmp_path, setup):
    """cli.train_pgm --device cpu --max_batches 2 on in-memory Morpho-MNIST
    datasets: two epochs, the checkpoint, and load_pgm_checkpoint reading it
    back with strict loads (the EMA identical)."""
    from causal_gen_tpu_torch.cli.train_pgm import main
    from causal_gen_tpu_torch.data import datasets as tds

    datasets = {"train": _datasets("morphomnist", 40, 0, tds),
                "valid": _datasets("morphomnist", 16, 1, tds)}
    state, history = main(["--dataset", "morphomnist", "--setup", setup, "--device", "cpu",
                           "--epochs", "2", "--bs", "8", "--max_batches", "2",
                           "--sup_frac", "0.3" if setup == "semi_sup" else "1.0",
                           "--save_dir", str(tmp_path)], datasets=datasets)
    assert state.step == 4  # semi_sup: 2 outer (unlabelled) batches an epoch
    assert all(np.isfinite(v) for v in history.values())
    if setup != "sup_pgm":
        assert "eval/digit_acc" in history and "eval/thickness_mae" in history
    else:  # the joint plots (matplotlib, seaborn and pandas are installed here)
        assert (tmp_path / "joint_samples.png").exists() and (tmp_path / "joint_data.png").exists()
    cfg, loaded, extra = ttp.load_pgm_checkpoint(str(tmp_path / "checkpoint"), "cpu")
    assert cfg.setup == setup and loaded.step == state.step
    for a, b in zip(loaded.ema.state_dict().values(), state.ema.state_dict().values()):
        assert torch.equal(a, b)
    assert dataclasses.asdict(cfg)["dataset"] == "morphomnist"


def test_cli_train_pgm_refuses_without_a_card(monkeypatch):
    """--device cuda (the default) raises where no card is present."""
    from causal_gen_tpu_torch.cli.train_pgm import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--setup", "sup_pgm", "--epochs", "1"])
