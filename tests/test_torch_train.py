"""The port's training path against the JAX package's: schedules, EMA, AdamW
under warmup, global-norm clipping, and train steps of the small Morpho-MNIST
HVAE (the diag_dgauss head) from converted parameters, fixed batches and the
same injected noise.

Tolerances: the units agree to float32 rounding (1e-6 rel, 1e-7 abs for
AdamW); train-step metrics to 1e-4 rel; parameters and EMA after three
updates to 1e-5 abs, element by element. The NLL is evaluated by one function
on both sides (torch_parity.patch_jax_nll_with_port). The DMoL head's steps
are in test_torch_dmol.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from causal_gen_tpu.train.state import clip_by_global_norm as jclip
from causal_gen_tpu.train.state import make_optimizer as jmake_optimizer
from causal_gen_tpu.utils.ema import ema_decay as jema_decay
from causal_gen_tpu.utils.ema import ema_update as jema_update
from causal_gen_tpu.utils.schedules import linear_warmup as jlinear_warmup
from causal_gen_tpu_torch.models.hvae import HVAE
from causal_gen_tpu_torch.train.state import (
    clip_by_global_norm,
    global_norm,
    init_train_state,
    make_optimizer,
)
from causal_gen_tpu_torch.train.vae_trainer import preprocess_x, train_step
from causal_gen_tpu_torch.utils.ema import ema_decay, ema_update
from causal_gen_tpu_torch.utils.schedules import linear_warmup

from tests.torch_parity import (
    assert_states_match,
    patch_jax_nll_with_port,
    run_steps_against_jax,
    small_morpho_cfg,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("warmup", [0, 4, 100])
def test_linear_warmup_matches_jax(warmup):
    for step in (0, 1, 3, 4, 5, 99, 100, 101, 1000):
        assert linear_warmup(step, warmup) == float(jlinear_warmup(step, warmup)), (step, warmup)


def test_ema_decay_and_update_match_jax():
    # post-increment count: a straight copy through update 101, then the schedule
    for n in (1, 50, 100, 101, 102, 103, 150, 10**4, 10**7):
        assert ema_decay(n, beta=0.999) == pytest.approx(float(jema_decay(n, beta=0.999)),
                                                         rel=1e-6, abs=0), n
    assert ema_decay(101) == 0.0 and ema_decay(102) > 0.0
    rng = np.random.default_rng(0)
    e, p = rng.normal(size=(2, 3, 5)).astype(np.float32)
    for n in (7, 103, 5000):
        ref = np.asarray(jema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, n)["w"])
        te = torch.from_numpy(e.copy())
        ema_update([te], [torch.from_numpy(p)], n)
        np.testing.assert_allclose(te.numpy(), ref, rtol=1e-6, atol=1e-7)
        if n <= 101:
            assert torch.equal(te, torch.from_numpy(p))  # the copy is exact


def test_adamw_warmup_matches_optax():
    """torch.optim.AdamW under LambdaLR against optax.adamw under the JAX
    schedule: lr(0) = 0, decoupled decay lr*wd*p on the old p, eps outside
    the square root. Gradients of 1e-8 make eps matter; wd 0.1 makes the
    decay term visible."""
    from causal_gen_tpu.config import get_config as jget
    from causal_gen_tpu_torch.config import get_config as tget

    over = dict(lr=1e-2, wd=0.1, lr_warmup_steps=3, betas=(0.9, 0.95))
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(4, 6)).astype(np.float32)
    grads = [rng.normal(size=(4, 6)).astype(np.float32) * s for s in (1.0, 1e-8, 3.0, 1e-3, 0.5)]
    opt = jmake_optimizer(jget("morphomnist", **over))
    jp = {"w": jnp.asarray(p0)}
    state = opt.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt, sched = make_optimizer(tget("morphomnist", **over), [tp])
    for k, g in enumerate(grads):
        upd, state = opt.update({"w": jnp.asarray(g)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
        sched.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp["w"]), rtol=1e-6,
                                   atol=1e-7, err_msg=f"update {k}")
        if k == 0:
            np.testing.assert_array_equal(tp.detach().numpy(), p0)  # lr(0) = 0


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    rng = np.random.default_rng(2)
    arrays = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 5))]
    jtree, jnorm = jclip({str(i): jnp.asarray(a) for i, a in enumerate(arrays)}, max_norm)
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    assert global_norm(ts).item() == pytest.approx(float(jnorm), rel=1e-6)
    norm = clip_by_global_norm(ts, max_norm)
    assert norm.item() == pytest.approx(float(jnorm), rel=1e-6)
    for i, t in enumerate(ts):
        np.testing.assert_allclose(t.numpy(), np.asarray(jtree[str(i)]), rtol=1e-6, atol=1e-7)


def test_preprocess_x_matches_jax():
    from causal_gen_tpu.train.vae_trainer import preprocess_x as jpre

    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    np.testing.assert_array_equal(
        preprocess_x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jpre(jnp.asarray(x))))


def test_train_steps_match_jax_dgauss(monkeypatch):
    """Three updates and one skipped step (a NaN parent) at accu_steps 2, with
    beta and lr warmup running, on the diag_dgauss head."""
    over = dict(accu_steps=2, beta_warmup_steps=3, lr_warmup_steps=2)
    jcfg, tcfg = small_morpho_cfg(True, **over), small_morpho_cfg(False, **over)
    patch_jax_nll_with_port(monkeypatch)  # see its docstring
    metrics, jstate, tstate = run_steps_against_jax(jcfg, tcfg, 1, 12, monkeypatch)
    assert [tm["skipped"] for _, tm in metrics] == [0.0, 0.0, 1.0, 0.0]
    assert_states_match(metrics, jstate, tstate)


def test_grad_skip_leaves_the_state_unchanged():
    """A step whose clipped-gradient norm reaches grad_skip changes no
    parameter, no AdamW moment, no EMA and no counter but ``skipped``."""
    cfg = small_morpho_cfg(False)
    state = init_train_state(cfg, HVAE(cfg, device="cpu",
                                       generator=torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(3)
    batch = {"x": torch.from_numpy(rng.integers(0, 256, (4, 1, 16, 16)).astype(np.uint8)),
             "pa": torch.from_numpy(rng.uniform(-1, 1, (4, 12)).astype(np.float32))}
    g = torch.Generator().manual_seed(1)
    train_step(cfg, state, batch, generator=g)  # one real update first
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    ema_before = {k: v.clone() for k, v in state.ema.state_dict().items()}
    moments = [s["exp_avg"].clone() for s in state.optimizer.state.values()]
    lr = state.optimizer.param_groups[0]["lr"]
    m = train_step(cfg.replace(grad_skip=1e-6), state, batch, generator=g)
    assert m["skipped"] == 1.0 and m["grad_norm"].item() > 1e-6
    assert (state.step, state.ema_updates, state.skipped) == (1, 1, 1)
    assert state.optimizer.param_groups[0]["lr"] == lr
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in state.ema.state_dict().items():
        assert torch.equal(v, ema_before[k]), k
    for a, s in zip(moments, state.optimizer.state.values()):
        assert torch.equal(a, s["exp_avg"])


def test_checkpoint_writer_keeps_newest_and_best(tmp_path):
    from causal_gen_tpu_torch.train.checkpoint import CheckpointWriter

    w = CheckpointWriter(str(tmp_path), max_to_keep=2)
    for step, metric in ((1, 3.0), (2, 1.0), (3, 2.0), (4, 4.0)):
        w.save({"w": torch.full((2,), float(step))}, {"extra": {}}, step=step, metric=metric)
    kept = sorted(p.name for p in tmp_path.glob("step_*.pt"))
    assert kept == ["step_0000000002.pt", "step_0000000004.pt"]  # the best and the newest
    assert os.readlink(tmp_path / "checkpoint") == "step_0000000002.pt"
    assert torch.load(tmp_path / "checkpoint", weights_only=True)["w"][0].item() == 2.0


def test_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    """cli.main on the CPU with in-memory datasets: 2 epochs, an evaluation,
    a checkpoint; then --resume continues from the stored state."""
    import functools

    from causal_gen_tpu_torch.cli import main as cli
    from causal_gen_tpu_torch.data.datasets import ArrayDataset
    from causal_gen_tpu_torch.train.checkpoint import load_checkpoint

    monkeypatch.setattr(cli, "MetricWriter", functools.partial(cli.MetricWriter,
                                                               tensorboard=False))
    rng = np.random.default_rng(6)

    def ds(n, aug):
        return ArrayDataset(images=rng.integers(0, 256, (n, 12, 12, 1)).astype(np.uint8),
                            attrs={"pa": rng.uniform(-1, 1, (n, 12)).astype(np.float32)},
                            columns=("pa",), aug=aug)

    datasets = {"train": ds(16, ("random_crop_flip", (16, 16), (2, 2), 0.0)),
                "valid": ds(8, ("center_pad", 2))}
    arch = ["--input_res", "16", "--enc_arch", "16b1d2,8b1d2,4b1d4,1b1", "--dec_arch",
            "1b1,4b1,8b1,16b1", "--widths", "8", "8", "16", "16", "--z_dim", "4",
            "--bias_max_res", "16", "--bs", "4", "--max_batches", "2"]
    save = str(tmp_path / "run")
    state, history = cli.main(["--hps", "morphomnist", "--device", "cpu", "--epochs", "2",
                               "--eval_freq", "2", "--save_dir", save] + arch,
                              datasets=datasets)
    assert state.step + state.skipped == 4 and np.isfinite(history["valid_elbo"])
    cfg, payload, extra = load_checkpoint(os.path.join(save, "checkpoint"))
    assert (cfg.epochs, cfg.bs, extra["epoch"]) == (2, 4, 2)
    assert payload["step"] == state.step
    for k, v in state.model.state_dict().items():
        assert torch.equal(payload["params"][k], v), k
    resumed, _ = cli.main(["--resume", os.path.join(save, "checkpoint"), "--device", "cpu",
                           "--epochs", "1", "--eval_freq", "1", "--save_dir",
                           str(tmp_path / "resumed"), "--max_batches", "2"], datasets=datasets)
    assert resumed.step + resumed.skipped - state.skipped == state.step + 2
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--hps", "morphomnist"], datasets=datasets)
