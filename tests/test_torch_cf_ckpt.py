"""The committed counterfactual fine-tuning checkpoints through the port.

Every committed CF tree (``checkpoints/*cf*``: the VAE fine-tuned, λ, their
EMA, both optax Adam states, the counters) converts with
``causal_gen_tpu_torch.convert.cf_state_from_jax`` into a
``pgm/train_cf.py::CFTrainState``: the VAE and its EMA load with
``strict=True`` (decoder runs unstacked), λ, the moments (``mu``, ``nu`` ->
``exp_avg``, ``exp_avg_sq``, transposed as their parameters) and the step
counts carry over exactly. The two flagships' CF trees are eval-grade
exports (``tools/export_eval_ckpt.py --kind cf``): they hold the EMA VAE
and λ alone, which load strictly into both, beside fresh optimizers.
``final_cf_eps`` is the one CF run whose tree is not committed (its
``checkpoint`` link dangles): nothing of it can load.

The four 32^2 trees (``final_cf``, ``final_cf_morph_tw25`` with the soft-
morphometry terms, ``cp_cf`` with the conditional prior, ``cf_cmnist``)
then run, resumed, at bs 1 on a synthetic digit under do(thickness) /
do(colour): ``DSCM.forward`` and the next update (``grad_skip`` lifted on
both sides, so that the update is made; the norm is clipped at 350) against
the JAX package's on the same inputs and posterior draws, recorded in
``tests/goldens/cf_ckpt.npz`` by ``tests/make_cf_ckpt_goldens.py`` (the JAX
side's compile of a full-width CF update takes about two minutes a tree;
the NLL goes through one function, ``torch_parity.patch_jax_nll_with_port``).
Held: the counterfactual's parents within 1e-5, cf_x within 1e-4, the
forward's scalars and the update's metrics within 1e-4 rel, λ and its EMA
within 1e-5, the parameters and their EMA (at fixed sampled elements of
every leaf) within 2 lr (Adam's sign flips, ROADMAP Queue 3). The 192^2
trees are only converted and loaded, to keep Tier-1's time down."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from causal_gen_tpu_torch.convert import (
    build_pgm,
    cf_state_from_jax,
    checkpoint_meta,
    config_from_hparams,
    params_from_jax,
    unstack_decoder,
)
from causal_gen_tpu_torch.models.simple_vae import build_vae
from causal_gen_tpu_torch.pgm import train_cf as tcf
from causal_gen_tpu_torch.pgm.dscm import DSCM

from tests.torch_parity import flax_checkpoint_numpy, nchw, vae_config_path

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints"
GOLDEN = pathlib.Path(__file__).resolve().parent / "goldens" / "cf_ckpt.npz"
MORPHO = ("final_morpho2", "long_pgm", "long_aux")
CMNIST = ("cmnist/final_cmnist", "sup_pgm_cmnist/cmnist_pgm", "sup_aux_cmnist/cmnist_aux")
# a CF run -> the VAE checkpoint whose configuration it fine-tuned (its eps
# is that checkpoint's best ELBO) and the PGM and predictor of its round
CF_TREES = {
    "final_cf": MORPHO,
    "final_cf_early": MORPHO,
    "cf_morphomnist/final_cf_morph": MORPHO,
    "cf_morphomnist/final_cf_morph_tw25": MORPHO,
    "cp_cf": ("real_morpho_cp", "real_pgm", "real_aux"),
    "cp_cf2": ("final_morpho_cp", "long_pgm", "long_aux"),
    "cf_cmnist": CMNIST,
    "cf_cmnist40": CMNIST,
    "ukbb192_flagship/cf": tuple(f"ukbb192_flagship/{r}" for r in ("vae", "pgm", "aux")),
    "mimic192_flagship/cf": tuple(f"mimic192_flagship/{r}" for r in ("vae", "pgm", "aux")),
}
RESUMED = ("final_cf", "cf_morphomnist/final_cf_morph_tw25", "cp_cf", "cf_cmnist")
# eval-grade exports (tools/export_eval_ckpt.py --kind cf): ema_trainable alone
EVAL_GRADE = ("ukbb192_flagship/cf", "mimic192_flagship/cf")
NOISE_SEED = 41


def paths(name):
    return (str(CKPT / name / "checkpoint"),) + tuple(str(CKPT / p / "checkpoint")
                                                      for p in CF_TREES[name])


def cf_config(name, **overrides):
    cfg, extra = tcf.load_cf_meta(paths(name)[0])
    return dataclasses.replace(cfg, **overrides), extra


def port_state(name, **overrides):
    """(CF config, the port's CFTrainState of the committed tree ``name`` on
    the CPU): the VAE built from its checkpoint's configuration, the PGM and
    the predictor from theirs (strict loads), then ``cf_state_from_jax``."""
    cf_path, vae_path, pgm_path, aux_path = paths(name)
    cfg, _ = cf_config(name, **overrides)
    vcfg = config_from_hparams(vae_config_path(vae_path))
    frozen = []
    for path, role in ((pgm_path, "pgm"), (aux_path, "aux")):
        mod = build_pgm(checkpoint_meta(path)["config"], role == "aux", "cpu")
        mod.load_state_dict(params_from_jax(flax_checkpoint_numpy(path, role)), strict=True)
        frozen.append(mod)
    dscm = DSCM(vcfg, *frozen, build_vae(vcfg, device="cpu"),
                elbo_constraint=cfg.elbo_constraint, lmbda_init=cfg.lmbda_init,
                damping=cfg.damping, thickness_weight=cfg.thickness_weight,
                intensity_weight=cfg.intensity_weight, thickness_calib=cfg.thickness_calib)
    state = tcf.init_cf_state(cfg, dscm)
    return cfg, cf_state_from_jax(flax_checkpoint_numpy(cf_path, "cf"), state)


def digit(res=32, seed=1):
    """A quantised synthetic stroke digit in [-1, 1], (res, res)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((res, res), np.float32)
    yy, xx = np.mgrid[:res, :res]
    pts = rng.uniform(res * 0.28, res * 0.72, (4, 2))
    w = rng.uniform(1.0, 2.0)
    for a, b in zip(pts[:-1], pts[1:]):
        for t in np.linspace(0, 1, 24):
            c = a + t * (b - a)
            img = np.maximum(img, np.exp(-((yy - c[0]) ** 2 + (xx - c[1]) ** 2) / (2 * w * w)))
    return (np.round(np.clip(img * 1.3, 0, 1) * 255) / 255 * 2 - 1).astype(np.float32)


def inputs(name):
    """(obs with NHWC x, dense do values, masks) at bs 1, numpy: a digit
    "3" of thickness 0.1 and intensity 0.3 under do(thickness = 0.6), or on
    Colour-MNIST a red-channel digit "3" of colour 2 under do(colour = 5)."""
    eye = np.eye(10, dtype=np.float32)
    x = digit()[None, :, :, None]
    if "cmnist" in name:
        obs = {"x": np.concatenate([x, -np.ones_like(x), -np.ones_like(x)], -1),
               "digit": eye[[3]], "colour": eye[[2]]}
        do, target = {"digit": np.zeros((1, 10), np.float32), "colour": eye[[5]]}, "colour"
    else:
        obs = {"x": x, "thickness": np.full((1, 1), 0.1, np.float32),
               "intensity": np.full((1, 1), 0.3, np.float32), "digit": eye[[3]]}
        do = {"thickness": np.full((1, 1), 0.6, np.float32),
              "intensity": np.zeros((1, 1), np.float32), "digit": np.zeros((1, 10), np.float32)}
        target = "thickness"
    mask = {k: np.full((1, 1), float(k == target), np.float32) for k in do}
    return obs, do, mask


SAMPLES = 64  # elements of each parameter compared after the update


def sample_index(name, shape):
    """Fixed flat indices of a parameter of the port's layout."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(sum(map(ord, name)))
    return np.sort(rng.choice(n, min(n, SAMPLES), replace=False))


@pytest.mark.parametrize("name", list(CF_TREES))
def test_cf_tree_converts_and_loads_strictly(name):
    cfg, state = port_state(name)
    tree = flax_checkpoint_numpy(paths(name)[0], "cf")
    eval_grade = name in EVAL_GRADE
    assert eval_grade == (not tree["trainable"]) == (not tree["opt_state"])
    for key, d in (("trainable", state.dscm), ("ema_trainable", state.ema)):
        src = tree["ema_trainable" if eval_grade else key]
        ref = params_from_jax(unstack_decoder(src["vae"]))
        got = d.vae.state_dict()
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (key, k)
        assert d.lmbda.item() == float(np.asarray(src["lmbda"]).reshape(()))
    assert (state.step, state.ema_updates, state.skipped) == (
        int(tree["step"]), int(tree["ema_updates"]), int(tree["skipped"]))
    assert state.dscm.lmbda.item() >= 0.0 and cfg.lr > 0
    if eval_grade:  # no optimizer state to carry: both start fresh
        assert not state.optimizer.state_dict()["state"]
        assert not state.lagrange_optimizer.state_dict()["state"]
        return
    adam = tree["opt_state"][0]
    mu, nu = (params_from_jax(unstack_decoder(adam[m])) for m in ("mu", "nu"))
    opt = state.optimizer.state_dict()
    for i, (k, _) in enumerate(state.dscm.vae.named_parameters()):
        s = opt["state"][i]
        assert torch.equal(s["exp_avg"], mu[k]) and torch.equal(s["exp_avg_sq"], nu[k]), k
        assert s["step"].item() == int(adam["count"])
    l_adam = tree["lagrange_opt_state"][1][0]
    ls = state.lagrange_optimizer.state_dict()["state"][0]
    assert ls["exp_avg"].item() == float(l_adam["mu"][0])
    assert ls["exp_avg_sq"].item() == float(l_adam["nu"][0])
    assert ls["step"].item() == int(l_adam["count"])


def test_final_cf_eps_has_no_committed_tree():
    """final_cf_eps committed its log and panel but not its tree: its link
    points at a save that is not in the repository, so the list above has it
    not."""
    link = CKPT / "final_cf_eps" / "checkpoint"
    assert link.is_symlink() and not link.exists()
    assert not (CKPT / "final_cf_eps" / "checkpoint.meta.json").exists()


def _golden(name):
    with np.load(GOLDEN) as f:
        return {k[len(name) + 1:]: f[k] for k in f.files if k.startswith(name + "/")}


@pytest.mark.parametrize("name", RESUMED)
def test_resumed_cf_tree_matches_jax(name):
    g = _golden(name)
    cfg, state = port_state(name, grad_skip=1e30)
    obs, do, mask = inputs(name)
    tobs = {k: nchw(v) if k == "x" else torch.from_numpy(v) for k, v in obs.items()}
    tdo = {k: torch.from_numpy(v) for k, v in do.items()}
    tmask = {k: torch.from_numpy(v) for k, v in mask.items()}
    rng = np.random.default_rng(NOISE_SEED)  # the JAX run's posterior draws, in order
    draws = [nchw(rng.standard_normal(tuple(sh)).astype(np.float32))
             for sh in g["noise_shapes"]]
    with torch.no_grad():
        out = state.dscm.forward(tobs, tdo, do_mask=tmask, noise=draws)
    np.testing.assert_allclose(out["cfs"]["x"].numpy(), nchw(g["forward/cf_x"]).numpy(),
                               atol=1e-4)
    for k in do:
        np.testing.assert_allclose(out["cfs"][k].numpy(), g[f"forward/cfs/{k}"], atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    for k in tcf.TERMS:
        assert out[k].item() == pytest.approx(float(g[f"forward/{k}"]), rel=1e-4, abs=1e-6), k
    step0 = state.step
    before = {k: v.clone() for k, v in state.dscm.vae.state_dict().items()}
    m = tcf.cf_train_step(cfg, state, tobs, tdo, tmask, noise=[draws])
    for k in tcf.TERMS + ("grad_norm", "lmbda", "skipped"):
        assert float(m[k]) == pytest.approx(float(g[f"update/{k}"]), rel=1e-4, abs=1e-6), k
    assert m["skipped"] == 0.0 and state.step == step0 + 1 == int(g["update/step"])
    assert state.ema_updates == int(g["update/ema_updates"])
    np.testing.assert_allclose(state.dscm.lmbda.item(), g["update/new_lmbda"].item(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.ema.lmbda.item(), g["update/new_ema_lmbda"].item(),
                               rtol=1e-5, atol=1e-5)
    bound = 2 * cfg.lr + 1e-6
    for key, d in (("params", state.dscm), ("ema", state.ema)):
        sd = d.vae.state_dict()
        got = np.concatenate([sd[k].flatten()[torch.from_numpy(sample_index(k, sd[k].shape))]
                              .numpy() for k in sorted(sd)])
        err = np.abs(got - g[f"update/{key}"])
        assert got.shape == err.shape and err.max() <= bound, (key, err.max())
    moved = max((v - before[k]).abs().max().item()
                for k, v in state.dscm.vae.state_dict().items())
    assert moved > cfg.lr / 2  # the update moved the parameters by Adam's step
