"""Counterfactual fine-tuning (``causal_gen_tpu_torch/pgm/train_cf.py``)
against ``causal_gen_tpu/pgm/train_cf.py``: three updates of
tests/test_dscm.py's Morpho-MNIST DSCM (16^2) from the same parameters, on
the same batches, interventions (``random_intervention`` from one numpy
seed on both sides) and posterior draws, in the variants the update has:
the plain Lagrangian, the soft-morphometry terms, ``accu_steps=2``, a
skipped update (``grad_skip`` tiny), λ pushed to its clamp at 0, remat.

Held: losses and metrics within 1e-4 rel, λ within 1e-5 abs + rel;
parameters and their EMA within 2 lr an update (Adam moves an element by
up to lr where a rounding-level gradient takes the other sign in the other
package: ROADMAP Queue 3, PR 14). Remat on against off in the port gives
the same gradients within 1e-6 rel, with injected draws and with a
generator (the recompute replays them); a saved, loaded and resumed state
takes the same next update as the state it was saved from.

The JAX step is jitted: its patched draws are made once, at trace time, and
serve every update and every microbatch, so the port takes the same draws
each time."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from causal_gen_tpu.pgm import train_cf as jcf
from causal_gen_tpu_torch.convert import params_from_jax
from causal_gen_tpu_torch.pgm import train_cf as tcf

from tests.torch_parity import (nchw, patch_jax_nll_with_port, patch_jax_noise, small_dscm_pair,
                                to_numpy)

torch.set_num_threads(1)

DAG = ("thickness", "intensity", "digit")
RES, BS = 16, 8
EPS = 5.5  # a little below the ELBO of these weights (~5.9): lmbda rises
MORPH = dict(thickness_weight=2.5, intensity_weight=0.05, thickness_calib=(1.2232, 0.5295))
# name: (CFConfig fields, DSCM fields); lr 1e-3 so that three updates move
# the parameters well past the 2 lr an update they are held to
VARIANTS = {
    "plain": (dict(lr=1e-3), {}),
    # eps above the ELBO: the ascent takes lmbda below 0 and the clamp back;
    # the gradient norm (~260) is clipped at 100
    "morph_clamp": (dict(lr=1e-3, lmbda_init=0.004, elbo_constraint=8.0, grad_clip=100.0,
                         **MORPH), dict(elbo_constraint=8.0, **MORPH)),
    "accu2_remat": (dict(lr=1e-3, accu_steps=2, cf_remat=True), {"remat": True}),
    "skip": (dict(lr=1e-3, grad_skip=1e-3), {}),
}


def _pair(dscm_fields):
    fields = {"elbo_constraint": EPS, **dscm_fields}
    return small_dscm_pair(seed=0, **fields)


def raw_batches(n, seed=0):
    """Loader-like batches (uint8 NHWC x, each parent in the PGM's space)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = np.zeros((BS, RES, RES, 1), np.float32)
        x[:, 4:12, 5:11] = rng.uniform(0.5, 1.0, (BS, 8, 6, 1))  # a bright block
        x += rng.uniform(0, 0.2, x.shape)
        out.append({"x": (np.clip(x, 0, 1) * 255).astype(np.uint8),
                    "thickness": rng.uniform(-0.8, 0.8, (BS, 1)).astype(np.float32),
                    "intensity": rng.uniform(-0.8, 0.8, (BS, 1)).astype(np.float32),
                    "digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, BS)]})
    return out


def torch_pgm_batch(raw):
    from causal_gen_tpu_torch.pgm.train_pgm import PGMConfig, preprocess_pgm_batch

    return preprocess_pgm_batch(PGMConfig(), raw, "cpu")


def jax_pgm_batch(raw):
    from causal_gen_tpu.pgm.train_pgm import PGMConfig, preprocess_pgm_batch

    return preprocess_pgm_batch(PGMConfig(), raw)


def run_updates(monkeypatch, variant, n=3):
    """``n`` updates of both packages; returns the metrics of each update
    (JAX's, the port's), the final JAX state and the port's state."""
    cfg_fields, dscm_fields = VARIANTS[variant]
    jdscm, vae_params, frozen, tdscm = _pair(dscm_fields)
    kw = {"bs": BS, "elbo_constraint": EPS, **cfg_fields}
    jcfg, tcfg = jcf.CFConfig(**kw), tcf.CFConfig(**kw)
    rec = patch_jax_noise(monkeypatch, seed=31)
    patch_jax_nll_with_port(monkeypatch)
    jstep = jax.jit(jcf._make_cf_step_body(jcfg, jdscm, frozen))
    jstate = jcf.init_cf_state(jcfg, jdscm, vae_params)
    tstate = tcf.init_cf_state(tcfg, tdscm)
    j_rng, t_rng = np.random.default_rng(5), np.random.default_rng(5)
    accu = tcfg.accu_steps
    out = []
    for s, raw in enumerate(raw_batches(n)):
        jb, tb = jax_pgm_batch(raw), torch_pgm_batch(raw)
        jdo = jcf.random_intervention(j_rng, DAG, jb, tcfg.do_pa)
        tdo = tcf.random_intervention(t_rng, DAG, tb, tcfg.do_pa)
        assert list(jdo) == list(tdo)
        np.testing.assert_array_equal(np.asarray(jdo[list(jdo)[0]]), tdo[list(tdo)[0]].numpy())
        jv, jm = jcf.dense_intervention(DAG, jb, jdo)
        tv, tm = tcf.dense_intervention(DAG, tb, tdo)
        jstate, jmet = jstep(jstate, *(jcf._reshape_accu_cf(t, accu) for t in (jb, jv, jm)),
                             jax.random.PRNGKey(s))
        assert len(rec.draws) == 8  # one trace: the factual pass's and the abduction's
        tmet = tcf.cf_train_step(tcfg, tstate, tb, tv, tm, noise=[rec.torch_noise()] * accu)
        out.append(({k: float(v) for k, v in jax.device_get(jmet).items()},
                    {k: float(v) for k, v in tmet.items()}))
    return out, jstate, tstate, tcfg


def assert_updates_match(metrics, jstate, tstate, lr):
    for s, (jm, tm) in enumerate(metrics):
        assert jm["skipped"] == tm["skipped"], s
        for k in ("loss", "aux_loss", "elbo", "nll", "kl", "morph_loss", "grad_norm"):
            assert tm[k] == pytest.approx(jm[k], rel=1e-4, abs=1e-7), (s, k, tm[k], jm[k])
        assert tm["lmbda"] == pytest.approx(jm["lmbda"], rel=1e-5, abs=1e-5), s
    assert (tstate.step, tstate.skipped, tstate.ema_updates) == (
        int(jstate.step), int(jstate.skipped), int(jstate.ema_updates))
    n_made = int(jstate.step)
    for tree, d in ((jstate.trainable, tstate.dscm), (jstate.ema_trainable, tstate.ema)):
        ref = params_from_jax(to_numpy(tree["vae"]))
        got = d.vae.state_dict()
        assert sorted(ref) == sorted(got)
        worst = max((got[k] - ref[k]).abs().max().item() for k in ref)
        assert worst <= 2 * lr * max(n_made, 1) + 1e-6, worst
        np.testing.assert_allclose(d.lmbda.detach().numpy(), np.asarray(tree["lmbda"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cf_updates_match_jax(monkeypatch, variant):
    metrics, jstate, tstate, cfg = run_updates(monkeypatch, variant)
    assert_updates_match(metrics, jstate, tstate, cfg.lr)
    made = [m for _, m in metrics if not m["skipped"]]
    if variant == "skip":
        assert not made and tstate.step == 0 and tstate.skipped == 3
    else:
        assert len(made) == 3
    if "morph" in variant:
        assert all(m["morph_loss"] > 0 for m in made)
    else:
        assert all(m["morph_loss"] == 0 for _, m in metrics)
    if variant == "morph_clamp":  # lmbda fell below 0 on the first update and was clamped
        assert metrics[0][1]["lmbda"] == pytest.approx(0.004)
        assert tstate.dscm.lmbda.item() == 0.0 and float(jstate.trainable["lmbda"][0]) == 0.0
        assert all(m["grad_norm"] > 100.0 for m in made)  # every update was clipped
    if variant == "plain":  # the constraint is broken, so the ascent raised lmbda
        assert tstate.dscm.lmbda.item() > 0.0


def _grads(tdscm, remat, batch, do, mask, noise=None, seed=None):
    tdscm.remat = remat
    for p in list(tdscm.vae.parameters()) + [tdscm.lmbda]:
        p.grad = None
    g = None if seed is None else torch.Generator().manual_seed(seed)
    out = tdscm.forward(batch, do, do_mask=mask, noise=noise, generator=g)
    out["loss"].backward()
    grads = [p.grad.clone() for p in list(tdscm.vae.parameters()) + [tdscm.lmbda]]
    return out, grads, g


@pytest.mark.parametrize("draws", ["noise", "generator"])
def test_remat_gives_the_same_gradients(draws):
    """Remat on against off: the same loss and gradients (1e-6 rel), the
    recompute replaying the injected draws or the generator's, and the
    generator left where a run without remat leaves it."""
    _, _, _, tdscm = _pair(MORPH)
    tb = torch_pgm_batch(raw_batches(1)[0])
    tdo = tcf.random_intervention(np.random.default_rng(1), DAG, tb)
    tv, tm = tcf.dense_intervention(DAG, tb, tdo)
    rng = np.random.default_rng(3)
    noise = None
    if draws == "noise":
        noise = [torch.from_numpy(rng.standard_normal((BS, 4, r, r)).astype(np.float32))
                 for r in (1, 4, 8, 16)] * 2
    runs = [_grads(tdscm, remat, tb, tv, tm, noise=noise, seed=None if noise else 11)
            for remat in (False, True)]
    (o0, g0, gen0), (o1, g1, gen1) = runs
    for k in ("loss", "elbo", "aux_loss", "morph_loss"):
        assert o1[k].item() == pytest.approx(o0[k].item(), rel=1e-6), k
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
    assert sum(float(a.abs().sum()) for a in g0) > 0
    if gen0 is not None:
        assert torch.equal(gen0.get_state(), gen1.get_state())


def test_save_load_resume_takes_the_same_next_update(tmp_path):
    """Two updates, a save, a load into a DSCM built anew, and the same next
    update on both: the parameters, λ, both optimizers and the EMA agree
    exactly."""
    cfg = tcf.CFConfig(bs=BS, lr=1e-3, elbo_constraint=EPS, **MORPH)
    _, _, _, tdscm = _pair(MORPH)
    state = tcf.init_cf_state(cfg, tdscm)
    batches = [torch_pgm_batch(r) for r in raw_batches(3, seed=4)]
    rng = np.random.default_rng(0)
    dos = [tcf.dense_intervention(DAG, b, tcf.random_intervention(rng, DAG, b))
           for b in batches]
    for b, (v, m) in zip(batches[:2], dos[:2]):
        tcf.cf_train_step(cfg, state, b, v, m, generator=torch.Generator().manual_seed(2))
    path = str(tmp_path / "cf.pt")
    tcf.save_cf_checkpoint(path, cfg, state, extra={"epoch": 2})
    other = _pair(MORPH)[3]
    cfg2, resumed, extra = tcf.load_cf_checkpoint(path, other)
    assert cfg2 == cfg and extra == {"epoch": 2}
    assert (resumed.step, resumed.ema_updates, resumed.skipped) == (2, 2, 0)
    v, m = dos[2]
    for st in (state, resumed):
        tcf.cf_train_step(cfg, st, batches[2], v, m, generator=torch.Generator().manual_seed(3))
    for a, b in ((state.dscm.vae, resumed.dscm.vae), (state.ema.vae, resumed.ema.vae)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    assert torch.equal(state.dscm.lmbda, resumed.dscm.lmbda)
    assert torch.equal(state.ema.lmbda, resumed.ema.lmbda)
    s0, s1 = state.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert all(torch.equal(s0[i]["exp_avg_sq"], s1[i]["exp_avg_sq"]) for i in s0)


def test_config_round_trip_and_steps_per_call():
    """CFConfig keeps the JAX package's fields and defaults; steps_per_call is
    stored and does not change an update."""
    import json

    names = [f.name for f in dataclasses.fields(tcf.CFConfig)]
    assert names == [f.name for f in dataclasses.fields(jcf.CFConfig)]
    assert dataclasses.asdict(tcf.CFConfig()) == dataclasses.asdict(jcf.CFConfig())
    cfg = tcf.CFConfig(steps_per_call=4, thickness_calib=(1.5, 0.25), betas=(0.8, 0.95))
    assert tcf.CFConfig.from_dict(json.loads(json.dumps(cfg.to_dict()))) == cfg


def test_dense_intervention_matches_jax():
    raw = raw_batches(1)[0]
    jb, tb = jax_pgm_batch(raw), torch_pgm_batch(raw)
    for pa in ("thickness", "digit", None):
        jdo = jcf.random_intervention(np.random.default_rng(9), DAG, jb, pa)
        tdo = tcf.random_intervention(np.random.default_rng(9), DAG, tb, pa)
        jv, jm = jcf.dense_intervention(DAG, jb, jdo)
        tv, tm = tcf.dense_intervention(DAG, tb, tdo)
        for k in DAG:
            np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    assert nchw(np.asarray(jb["x"])).shape == tb["x"].shape
