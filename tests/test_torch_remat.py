"""HVAE block remat in the port against the JAX package's choice of unit.

- ``plan_decoder_layout`` is JAX's for every registry config.
- Gradients with remat on and off agree within 1e-6 rel (they are the same
  bits on the CPU: the recompute replays the draws), in both layouts
  (``stage_scan`` off: each decoder block's three conv ``Block``s; on: the
  whole block of a run, its K1 draw inside), at ``remat_min_res`` 0 and
  above the lowest resolution, with injected draws and with a generator.
- With ``accu_steps`` 2 each microbatch's recompute replays its own draws:
  the update is the same with remat on and off.
- Remat changes what autograd stores: fewer bytes kept for the backward,
  and none saved where ``remat_min_res`` lies above every resolution.
- One JAX train step of ``remat=True, stage_scan=True`` against the port's
  from converted parameters and the same draws: metrics 1e-4 rel,
  parameters and EMA 1e-5 abs (``tests/test_torch_train.py``'s tolerance).
- ``cli.main --stage_scan --remat --remat_min_res R`` trains.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.config import CONFIG_REGISTRY as JAX_REGISTRY
from causal_gen_tpu.config import get_config as jget_config
from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.models.hvae import plan_decoder_layout as jplan_decoder_layout
from causal_gen_tpu.train.state import init_train_state as jinit_state
from causal_gen_tpu.train.vae_trainer import _make_step_body, init_model_params
from causal_gen_tpu_torch.config import CONFIG_REGISTRY, get_config
from causal_gen_tpu_torch.convert import params_from_jax, unstack_decoder
from causal_gen_tpu_torch.models.hvae import (
    HVAE,
    plan_decoder_blocks,
    plan_decoder_layout,
    remat_cells,
)
from causal_gen_tpu_torch.train.state import init_train_state
from causal_gen_tpu_torch.train.vae_trainer import train_step

from tests.torch_parity import nchw, patch_jax_nll_with_port, to_numpy

torch.set_num_threads(2)

# a decoder with a run of three blocks at 8^2 (blocks 3-5) between singles
ARCH = dict(bs=4, input_res=16, enc_arch="16b2d2,8b2d2,4b1d4,1b1",
            dec_arch="1b1,4b1,8b4,16b1", widths=(8, 8, 16, 16), z_dim=4, bias_max_res=16)


def tiny(**over):
    return get_config("morphomnist", **{**ARCH, **over})


@pytest.mark.parametrize("name", sorted(CONFIG_REGISTRY))
def test_layout_plan_is_jax_s(name):
    assert sorted(CONFIG_REGISTRY) == sorted(JAX_REGISTRY)
    assert plan_decoder_layout(get_config(name)) == [tuple(e) for e in
                                                     jplan_decoder_layout(jget_config(name))]


def test_remat_cells_follow_the_runs():
    assert plan_decoder_layout(tiny()) == [("single", 0), ("single", 1), ("single", 2),
                                           ("run", 3, 3), ("single", 6)]
    assert remat_cells(tiny(remat=True, stage_scan=True)) == [3, 4, 5]
    assert remat_cells(tiny(remat=True, stage_scan=True, remat_min_res=16)) == []
    assert remat_cells(tiny(remat=True)) == remat_cells(tiny(stage_scan=True)) == []


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(-1, 1, (4, 1, 16, 16)), dtype=torch.float32),
            torch.tensor(rng.uniform(-1, 1, (4, 12)), dtype=torch.float32))


def _grads(cfg, draws):
    """ELBO and gradients of one pass, with the injected ``draws`` (a list)
    or, when an int, a generator of that seed."""
    model = HVAE(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    x, pa = _batch()
    if isinstance(draws, int):
        out = model(x, pa, generator=torch.Generator().manual_seed(draws))
    else:
        out = model(x, pa, noise=iter(draws))
    out["elbo"].backward()
    return out["elbo"].item(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("source", ["injected", "generator"])
@pytest.mark.parametrize("min_res", [0, 8])
@pytest.mark.parametrize("stage_scan", [False, True])
def test_remat_keeps_the_gradients(stage_scan, min_res, source):
    """1e-6 rel on every gradient (the same bits here)."""
    cfg = tiny(stage_scan=stage_scan, remat_min_res=min_res)
    rng = np.random.default_rng(1)
    draws = (3 if source == "generator" else
             [torch.tensor(rng.standard_normal((4, 4, r, r)), dtype=torch.float32)
              for r, _ in plan_decoder_blocks(cfg)])
    elbo0, g0 = _grads(cfg, draws)
    elbo1, g1 = _grads(cfg.replace(remat=True), draws)
    assert elbo1 == pytest.approx(elbo0, rel=1e-6)
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert (g1[k] - g0[k]).abs().max() <= 1e-6 * g0[k].abs().max() + 1e-30, k


@pytest.mark.parametrize("source", ["injected", "generator"])
def test_microbatches_replay_their_own_draws(source):
    """A train step of 2 microbatches (accu_steps 2) with remat on and off:
    each microbatch's recompute takes its own draws, so the metrics and the
    updated parameters agree within 1e-6 rel."""
    cfg = tiny(stage_scan=True, accu_steps=2)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 256, (4, 1, 16, 16)).astype(np.uint8))
    batch = {"x": x, "pa": torch.tensor(rng.uniform(-1, 1, (4, 12)), dtype=torch.float32)}
    noise = [[torch.tensor(rng.standard_normal((2, 4, r, r)), dtype=torch.float32)
              for r, _ in plan_decoder_blocks(cfg)] for _ in range(2)]
    out = {}
    for on in (False, True):
        model = HVAE(cfg.replace(remat=on), device="cpu",
                     generator=torch.Generator().manual_seed(0))
        state = init_train_state(cfg, model)
        kw = ({"noise": noise} if source == "injected"
              else {"generator": torch.Generator().manual_seed(4)})
        m = train_step(cfg.replace(remat=on), state, batch, **kw)
        out[on] = ({k: float(v) for k, v in m.items()}, model.state_dict())
    (m0, p0), (m1, p1) = out[False], out[True]
    for k in m0:
        assert m1[k] == pytest.approx(m0[k], rel=1e-6), k
    for k in p0:
        assert torch.allclose(p1[k], p0[k], rtol=1e-6, atol=1e-9), k


def _saved_bytes(cfg):
    """Bytes autograd keeps for the backward of one ELBO (outside every
    checkpoint: a checkpoint keeps its inputs and recomputes the rest)."""
    model = HVAE(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    x, pa = _batch()
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x, pa, generator=torch.Generator().manual_seed(3))["elbo"].backward()
    return total[0]


@pytest.mark.parametrize("stage_scan", [False, True])
def test_remat_changes_what_is_stored(stage_scan):
    cfg = tiny(stage_scan=stage_scan)
    plain = _saved_bytes(cfg)
    assert _saved_bytes(cfg.replace(remat=True, remat_min_res=99)) == plain
    some = _saved_bytes(cfg.replace(remat=True, remat_min_res=8))
    every = _saved_bytes(cfg.replace(remat=True))
    assert every < some < plain, (every, some, plain)


class RunDraws:
    """``causal_gen_tpu.models.hvae.sample_gaussian`` for a jitted step of a
    ``stage_scan`` model: flax traces a scanned run's body twice and the
    compiled scan takes the traced draw for each of its blocks, so a run's
    traces get one draw, which the port takes for each block of the run.
    ``sites``: (traces, blocks) per stochastic layout element, in order."""

    def __init__(self, seed, sites):
        self.rng = np.random.default_rng(seed)
        self.sites = sites
        self.calls = 0
        self.draws = []

    def __call__(self, key, loc, logscale):
        k, n = self.calls, 0
        for site, (traces, _) in enumerate(self.sites):
            if k < n + traces:
                break
            n += traces
        if site == len(self.draws):
            self.draws.append(self.rng.standard_normal(loc.shape).astype(np.float32))
        self.calls += 1
        return loc + jnp.exp(logscale) * jnp.asarray(self.draws[site])

    def torch_noise(self):
        return [nchw(d) for d, (_, blocks) in zip(self.draws, self.sites) for _ in range(blocks)]


def test_jax_scanned_remat_step_matches(monkeypatch):
    """Two train steps of ``remat=True, stage_scan=True`` from the same
    converted parameters, batches and draws; the second has a NaN parent,
    so both skip it."""
    import causal_gen_tpu.models.hvae as jax_hvae

    over = dict(ARCH, bs=8, remat=True, stage_scan=True)
    jcfg, tcfg = jget_config("morphomnist", **over), get_config("morphomnist", **over)
    patch_jax_nll_with_port(monkeypatch)
    jvae = JHVAE(cfg=jcfg)
    params = init_model_params(jcfg, jvae, jax.random.PRNGKey(0))
    assert "run_3" in params["decoder"]
    stages = plan_decoder_blocks(tcfg)
    sites = [(1, 1) if e[0] == "single" else (2, e[2]) for e in plan_decoder_layout(tcfg)
             if stages[e[1]][0] <= tcfg.z_max_res]
    rec = RunDraws(5, sites)
    monkeypatch.setattr(jax_hvae, "sample_gaussian", rec)
    jstate = jinit_state(jcfg, params)
    tvae = HVAE(tcfg, device="cpu")
    tvae.load_state_dict(params_from_jax(unstack_decoder(to_numpy(params))))
    tstate = init_train_state(tcfg, tvae)
    assert tvae.decoder._cells == {3, 4, 5}
    jstep = jax.jit(_make_step_body(jcfg, jvae))
    rng = np.random.default_rng(0)
    for s in range(2):
        x = rng.integers(0, 256, (1, 8, 16, 16, 1)).astype(np.uint8)
        pa = rng.uniform(-1, 1, (1, 8, 12)).astype(np.float32)
        if s == 1:
            pa[0, 0, 0] = np.nan
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "pa": jnp.asarray(pa)},
                           jax.random.PRNGKey(s))
        assert rec.calls == sum(t for t, _ in sites)  # one trace of the step
        batch = {"x": torch.from_numpy(x[0]).permute(0, 3, 1, 2).contiguous(),
                 "pa": torch.from_numpy(pa[0])}
        tm = train_step(tcfg, tstate, batch, noise=[rec.torch_noise()])
        jm = {k: float(v) for k, v in jax.device_get(jm).items()}
        assert jm["skipped"] == tm["skipped"] == float(s == 1)
        for k in ("elbo", "nll", "kl", "grad_norm"):
            if s == 1 and np.isnan(jm[k]):
                assert np.isnan(float(tm[k])), k
            else:
                assert float(tm[k]) == pytest.approx(jm[k], rel=1e-4), (s, k)
    assert (tstate.step, tstate.skipped) == (int(jstate.step), int(jstate.skipped)) == (1, 1)
    for tree, module in ((jstate.params, tstate.model), (jstate.ema_params, tstate.ema)):
        ref = params_from_jax(unstack_decoder(to_numpy(tree)))
        got = module.state_dict()
        assert sorted(ref) == sorted(got)
        worst = max((got[k] - ref[k]).abs().max().item() for k in ref)
        assert worst <= 1e-5, worst


def test_cli_trains_with_remat(tmp_path, monkeypatch):
    """cli.main --stage_scan --remat --remat_min_res 8 on in-memory data: 2
    epochs of 2 steps, the run's cells rematerialised, the checkpoint's
    config keeps the flags, the early viz grid written."""
    from causal_gen_tpu_torch.cli import main as cli
    from causal_gen_tpu_torch.data.datasets import ArrayDataset
    from causal_gen_tpu_torch.train.checkpoint import load_checkpoint

    monkeypatch.setattr(cli, "MetricWriter", functools.partial(cli.MetricWriter,
                                                               tensorboard=False))
    rng = np.random.default_rng(6)

    def ds(n):
        return ArrayDataset(images=rng.integers(0, 256, (n, 16, 16, 1)).astype(np.uint8),
                            attrs={"pa": rng.uniform(-1, 1, (n, 12)).astype(np.float32)},
                            columns=("pa",))

    arch = ["--input_res", "16", "--enc_arch", ARCH["enc_arch"], "--dec_arch",
            ARCH["dec_arch"], "--widths", "8", "8", "16", "16", "--z_dim", "4",
            "--bias_max_res", "16", "--bs", "4", "--max_batches", "2"]
    save = str(tmp_path / "run")
    state, history = cli.main(["--hps", "morphomnist", "--device", "cpu", "--epochs", "2",
                               "--eval_freq", "2", "--save_dir", save, "--stage_scan",
                               "--remat", "--remat_min_res", "8"] + arch,
                              datasets={"train": ds(8), "valid": ds(8)})
    assert state.step + state.skipped == 4 and np.isfinite(history["valid_elbo"])
    assert state.model.decoder._cells == {3, 4, 5}
    assert [b.remat for b in state.model.encoder._blocks] == [True] * 6 + [False] * 3
    cfg, _, _ = load_checkpoint(os.path.join(save, "checkpoint"))
    assert (cfg.remat, cfg.stage_scan, cfg.remat_min_res) == (True, True, 8)
    assert sorted(f for f in os.listdir(save) if f.startswith("viz-")) == ["viz-1.png"]
