"""Data parallelism of the port's HVAE step (``parallel/mesh.py``,
``train/vae_trainer.py``) over gloo ranks on the CPU, each rank a process of
its own (``parallel/launch.py::spawn``), against one process at the same
global batch and against the JAX step on the 8-device CPU mesh (the CF and
PGM steps: ``test_torch_parallel_cf_pgm.py``).

- HVAE step (``train/vae_trainer.py``) at world 2 and 4, two updates with
  warmup-free lr, the injected draws each rank's rows: plain, with
  ``accu_steps`` 2 (each rank takes its rows of each microbatch), and with
  free bits at 0.4 nats, where the last block's per-channel batch-mean KL
  straddles the clamp between the ranks' halves (0.16 and 0.56 against a
  global 0.36 at init), so a rank's own mean would give another gradient.
  Metrics 1e-5 rel, parameters and EMA within 2 lr an update and all but
  a thousandth of them within 1e-5.
- The same step against JAX's ``make_train_step`` body on the 8-device
  ``data`` mesh from converted parameters and the same draws (its NLL
  through the port's, ``torch_parity.patch_jax_nll_with_port``): metrics
  1e-4 rel; parameters all within 2 lr and all but one in a thousand within
  1e-5 (AdamW's first update is lr sign(g) where |g| >> eps, so an element
  whose gradient is at rounding level may move either way: 1 of 9,698).

A hung rank fails its test after ``torch_dist.TIMEOUT_S``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.config import get_config as jget_config
from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.parallel.mesh import make_mesh as jmake_mesh
from causal_gen_tpu.parallel.mesh import replicate as jreplicate
from causal_gen_tpu.parallel.mesh import shard_batch as jshard_batch
from causal_gen_tpu.train.state import init_train_state as jinit_state
from causal_gen_tpu.train.vae_trainer import _make_step_body, init_model_params
from causal_gen_tpu_torch.convert import params_from_jax
from causal_gen_tpu_torch.parallel.launch import spawn

from tests import torch_dist as td
from tests.torch_parity import nchw, patch_jax_nll_with_port, patch_jax_noise, to_numpy

torch.set_num_threads(1)

LR = 1e-3
HVAE_CASES = {"plain": {}, "accu2": dict(accu_steps=2), "free_bits": dict(kl_free_bits=0.4)}
N_STEPS = 2


def hvae_cfg(case):
    return td.tiny_cfg(lr_warmup_steps=0, **HVAE_CASES[case])


def assert_runs_match(ref, got, lr, metric_rtol=1e-5, keys=("elbo", "nll", "kl", "grad_norm")):
    for s, (a, b) in enumerate(zip(ref["metrics"], got["metrics"])):
        assert a["skipped"] == b["skipped"] == 0.0, s
        for k in keys:
            assert b[k] == pytest.approx(a[k], rel=metric_rtol), (s, k, b[k], a[k])
    for tree in ("params", "ema"):
        td.assert_params_close(ref[tree], got[tree], lr, len(ref["metrics"]), tree)


def test_free_bits_clamp_straddles_the_ranks_halves():
    """The free-bits case tests what it says: at init some channel's
    batch-mean KL is under the clamp on the whole batch and over it on one
    rank's half (so a rank's own mean gives another gradient)."""
    from causal_gen_tpu_torch.train.vae_trainer import preprocess_x

    cfg = hvae_cfg("free_bits")
    st = td.hvae_inputs(cfg, 1)[0]
    model = td.build_hvae(cfg)
    with torch.no_grad():
        acts = model.encoder(preprocess_x(torch.from_numpy(st["x"])))
        _, stats = model.decoder(torch.from_numpy(st["pa"]), acts=acts,
                                 noise=iter(torch.from_numpy(e) for e in st["noise"][0]))
    fb, half = cfg.kl_free_bits, cfg.bs // 2
    straddles = [bool(((s["kl"].mean(0) < fb) & ((s["kl"][:half].mean(0) > fb)
                                                  | (s["kl"][half:].mean(0) > fb))).any())
                 for s in stats]
    assert any(straddles)


@pytest.fixture(scope="module")
def jax_dp_step():
    """One JAX train step of the tiny HVAE on the 8-device data mesh, from
    its init: its metrics, new parameters, initial parameters, the batch
    and the draws."""
    over = dict(bs=8, input_res=16, enc_arch="16b1d2,8b1d2,4b1d4,1b1",
                dec_arch="1b1,4b1,8b1,16b1", widths=(8, 8, 16, 16), z_dim=4, context_dim=12,
                accu_steps=1, bias_max_res=16, lr=LR, lr_warmup_steps=0)
    jcfg = jget_config("morphomnist", **over)
    jvae = JHVAE(cfg=jcfg)
    params = init_model_params(jcfg, jvae, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"x": rng.integers(0, 256, (1, 8, 16, 16, 1)).astype(np.uint8),
             "pa": rng.uniform(-1, 1, (1, 8, 12)).astype(np.float32)}
    mesh = jmake_mesh((8,), ("data",))
    with pytest.MonkeyPatch.context() as mp:
        rec = patch_jax_noise(mp, seed=5)
        patch_jax_nll_with_port(mp)
        step = jax.jit(_make_step_body(jcfg, jvae))
        with mesh:
            state = jreplicate(jinit_state(jcfg, params), mesh)
            new, m = step(state, jshard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()},
                                              batch_dim=1), jax.random.PRNGKey(3))
            m = {k: float(v) for k, v in jax.device_get(m).items()}
    return (m, params_from_jax(to_numpy(new.params)), params_from_jax(to_numpy(params)),
            batch, list(rec.draws))


def _converted_run(cfg, params, step, mesh=None):
    """One port step from the converted parameters (on this rank's rows)."""
    model = td.build_hvae(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return td.run_steps_on(cfg, model, [step], mesh)


def _rank(rank, world, device, jax_params, jax_step):
    """Every check's run on this rank, in one process group: the HVAE cases
    and the step from JAX's parameters."""
    from causal_gen_tpu_torch.parallel import make_mesh

    mesh = make_mesh((world,), ("data",))
    out = {c: td.run_hvae_steps(hvae_cfg(c), td.hvae_inputs(hvae_cfg(c), N_STEPS), mesh)
           for c in HVAE_CASES}
    out["jax"] = _converted_run(td.tiny_cfg(lr_warmup_steps=0, lr=LR), jax_params, jax_step, mesh)
    return out


@pytest.fixture(scope="module")
def runs(jax_dp_step):
    """The one-process runs, and one spawn a world size (2 and 4) that runs
    every check's ranks."""
    jm, jnew, params, batch, draws = jax_dp_step
    step = {"x": nchw(batch["x"][0]).to(torch.uint8).numpy(), "pa": batch["pa"][0],
            "noise": [[nchw(e).numpy() for e in draws]]}
    params = {k: v.numpy() for k, v in params.items()}
    ref = {c: td.run_hvae_steps(hvae_cfg(c), td.hvae_inputs(hvae_cfg(c), N_STEPS))
           for c in HVAE_CASES}
    par = {w: spawn(_rank, w, (params, step), timeout=td.TIMEOUT_S) for w in (2, 4)}
    return ref, par


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(HVAE_CASES))
def test_dp_hvae_step_matches_one_process(runs, case, world):
    ref, par = runs
    for rank, got in enumerate(par[world]):
        assert_runs_match(ref[case], got[case], hvae_cfg(case).lr)
        # every rank holds the same parameters after the update
        for k, v in got[case]["params"].items():
            np.testing.assert_array_equal(v, par[world][0][case]["params"][k], err_msg=(rank, k))


@pytest.mark.parametrize("world", [2, 4])
def test_dp_hvae_step_matches_jax_on_its_mesh(jax_dp_step, runs, world):
    jm, jnew = jax_dp_step[:2]
    for out in (r["jax"] for r in runs[1][world]):
        tm = out["metrics"][0]
        for k in ("elbo", "nll", "kl", "grad_norm"):
            assert tm[k] == pytest.approx(jm[k], rel=1e-4), (k, tm[k], jm[k])
        errs = np.concatenate([np.abs(out["params"][k] - jnew[k].numpy()).ravel() for k in jnew])
        assert errs.max() <= 2 * LR, errs.max()
        assert (errs > 1e-5).mean() <= 1e-3, int((errs > 1e-5).sum())
