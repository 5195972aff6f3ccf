"""The CF evaluation and the stage-3 entry points of the port on synthetic
data, on the CPU:

- ``pgm/train_cf.py::cf_get_metrics`` against JAX's on every dataset's
  variables (1e-6 rel);
- ``eval/cf_eval.py::eval_counterfactuals`` and ``eval_cf_loop`` against
  ``causal_gen_tpu/eval/cf_eval.py`` on tests/test_dscm.py's small
  Morpho-MNIST DSCM (16^2), the same interventions (both draw them from one
  numpy seed) and abduction draws: the metrics and the re-measured
  morphometrics within 1e-4 rel, the seeds' mean and std too;
- ``cli.evaluate --device cpu`` on checkpoints that
  ``convert.save_mechanism_checkpoints`` writes from the same trees: its
  printed metrics are ``eval_cf_loop``'s, of the VAE checkpoint or, with
  ``--cf_path``, of a CF checkpoint's EMA VAE;
- ``cli.train_cf --device cpu``: two epochs of two batches with the
  per-parent valid sweeps, the ``checkpoint`` link on the save of the lower
  random-do valid loss, and a resume for a third epoch (the counters, the
  epoch, both optimizers and the fitted calibration carry on).
"""

import json
import os

import numpy as np
import pytest
import torch

from causal_gen_tpu.pgm import train_cf as jcf
from causal_gen_tpu_torch.pgm import train_cf as tcf

from tests.torch_parity import patch_jax_nll_with_port, patch_jax_noise, small_dscm_pair

torch.set_num_threads(1)

RES = 16
DAG = ("thickness", "intensity", "digit")


def test_cf_get_metrics_matches_jax():
    rng = np.random.default_rng(0)
    n = 40
    cont = lambda: rng.uniform(-1, 1, (n, 1)).astype(np.float32)  # noqa: E731
    binary = lambda: rng.integers(0, 2, (n, 1)).astype(np.float32)  # noqa: E731
    onehot = lambda k: np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]  # noqa: E731
    sets = {"morphomnist": {"thickness": cont, "intensity": cont, "digit": lambda: onehot(10)},
            "ukbb192": {"sex": binary, "mri_seq": binary, "age": cont, "brain_volume": cont,
                        "ventricle_volume": cont},
            "mimic192": {"sex": binary, "age": cont, "race": lambda: onehot(3),
                         "finding": binary},
            "cmnist": {"digit": lambda: onehot(10), "colour": lambda: onehot(10)}}
    for name, kinds in sets.items():
        T = {k: f() for k, f in kinds.items()}
        P = {k: np.clip(v + rng.normal(0, 0.3, v.shape), 0 if v.shape[1] > 1 else -1, 1)
             .astype(np.float32) for k, v in T.items()}
        ref = jcf.cf_get_metrics(name, P, T)
        got = tcf.cf_get_metrics(name, P, T)
        assert sorted(got) == sorted(ref), name
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-6, nan_ok=True), (name, k)


def datasets(n_train=24, n_eval=12, seed=0, port=True):
    """Morpho-MNIST-like ArrayDatasets (a bright stroke on a dark 16^2 image,
    thickness and intensity in [-1, 1], a digit one-hot), for both
    packages."""
    if port:
        from causal_gen_tpu_torch.data.datasets import ArrayDataset
    else:
        from causal_gen_tpu.data.datasets import ArrayDataset
    rng = np.random.default_rng(seed)

    def make(n):
        x = np.zeros((n, RES, RES, 1), np.float32)
        for i in range(n):
            r = rng.integers(3, 8)
            x[i, r:r + 7, 4:4 + rng.integers(2, 5)] = rng.uniform(0.6, 1.0)
        x += rng.uniform(0, 0.1, x.shape)
        attrs = {"thickness": rng.uniform(-1, 1, n).astype(np.float32),
                 "intensity": rng.uniform(-1, 1, n).astype(np.float32),
                 "digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]}
        return ArrayDataset(images=(np.clip(x, 0, 1) * 255).astype(np.uint8), attrs=attrs,
                            columns=DAG)

    return {"train": make(n_train), "valid": make(n_eval), "test": make(n_eval)}


def _eval_pair(monkeypatch):
    jdscm, vae_params, frozen, tdscm = small_dscm_pair(seed=1)
    rec = patch_jax_noise(monkeypatch, seed=51)
    patch_jax_nll_with_port(monkeypatch)
    return jdscm, vae_params, frozen, tdscm, rec


@pytest.mark.parametrize("do_pa", [None, "intensity"])
def test_eval_counterfactuals_matches_jax(monkeypatch, do_pa):
    from causal_gen_tpu.data.loader import Loader as JLoader
    from causal_gen_tpu.eval import cf_eval as jev
    from causal_gen_tpu_torch.data.loader import Loader
    from causal_gen_tpu_torch.eval import cf_eval as tev

    jdscm, vae_params, frozen, tdscm, rec = _eval_pair(monkeypatch)
    jds, tds = datasets(port=False), datasets()
    bs = 4
    jl = JLoader(jds["test"], bs, shuffle=False, drop_last=False, concat_pa=False)
    tl = Loader(tds["test"], bs, shuffle=False, drop_last=False, concat_pa=False)
    train_attrs = {k: np.asarray(v) for k, v in tds["train"].attrs.items()}
    ref = jev.eval_counterfactuals(jdscm.cfg, jdscm.vae, vae_params, jdscm.pgm, frozen["pgm"],
                                   jdscm.predictor, frozen["predictor"], jl, train_attrs,
                                   do_pa=do_pa, seed=3)
    assert len(rec.draws) == 4  # one trace: the abduction's draws serve every batch
    noise = [rec.torch_noise()] * len(tl)
    with torch.no_grad():
        got = tev.eval_counterfactuals(tdscm.cfg, tdscm.vae, tdscm.pgm, tdscm.predictor, tl,
                                       train_attrs, "cpu", do_pa=do_pa, seed=3, noise=noise)
    assert sorted(got) == sorted(ref)
    assert "thickness_measured_mae" in got and "digit_acc" in got
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-6), (k, got[k], ref[k])


def _write_checkpoints(tmp_path, seed=1):
    """The small pair's three trees as the port's checkpoints
    (convert.save_mechanism_checkpoints); returns (paths, the port's DSCM)."""
    from causal_gen_tpu_torch.convert import save_mechanism_checkpoints
    from causal_gen_tpu_torch.pgm.train_pgm import PGMConfig

    from tests.torch_parity import to_numpy

    _, vae_params, frozen, tdscm = small_dscm_pair(seed=seed)
    trees = {"vae": to_numpy(vae_params), "pgm": frozen["pgm"], "aux": frozen["predictor"]}
    metas = {"vae": {"config": tdscm.cfg.to_dict(), "extra": {"best_loss": 5.5}},
             "pgm": {"config": PGMConfig(setup="sup_pgm", input_res=RES).to_dict()},
             "aux": {"config": PGMConfig(setup="sup_aux", input_res=RES).to_dict()}}
    return save_mechanism_checkpoints(str(tmp_path / "mech"), trees, metas), tdscm


@pytest.mark.parametrize("cf_path", [False, True])
def test_cli_evaluate_prints_eval_cf_loop(tmp_path, capsys, cf_path):
    """cli.evaluate prints eval_cf_loop's metrics of the VAE checkpoint, or
    with --cf_path those of a CF checkpoint's EMA VAE."""
    import copy

    from causal_gen_tpu_torch.cli import evaluate
    from causal_gen_tpu_torch.data.loader import Loader
    from causal_gen_tpu_torch.eval.cf_eval import eval_cf_loop

    paths, tdscm = _write_checkpoints(tmp_path)
    ds = datasets()
    argv = ["--pgm_path", paths["pgm"], "--predictor_path", paths["aux"], "--vae_path",
            paths["vae"], "--device", "cpu", "--bs", "4", "--seeds", "0", "1"]
    vae = tdscm.vae
    if cf_path:
        cfg = tcf.CFConfig(elbo_constraint=5.5)
        state = tcf.init_cf_state(cfg, tdscm)
        with torch.no_grad():  # an EMA VAE that differs from the VAE checkpoint's
            for p in state.ema.vae.parameters():
                p.mul_(0.9)
        tcf.save_cf_checkpoint(str(tmp_path / "cf.pt"), cfg, state, extra={"epoch": 3})
        argv += ["--cf_path", str(tmp_path / "cf.pt")]
        vae = copy.deepcopy(state.ema.vae)
    out = evaluate.main(argv, datasets=ds)
    printed = capsys.readouterr().out
    assert ("(epoch 3)" in printed) == cf_path
    assert json.loads(printed[printed.index("{"):]) == json.loads(json.dumps(out))
    loader = Loader(ds["test"], 4, shuffle=False, drop_last=False, concat_pa=False)
    ref = eval_cf_loop(tdscm.cfg, vae, tdscm.pgm, tdscm.predictor, loader,
                       {k: np.asarray(v) for k, v in ds["train"].attrs.items()}, "cpu",
                       seeds=(0, 1))
    assert sorted(out["metrics"]) == sorted(ref)
    for k, (mean, std) in ref.items():
        assert out["metrics"][k] == {"mean": mean, "std": std}, k
    assert out["non_image_parents_expected_invariant"] == []


def test_eval_cf_loop_mean_and_std_match_jax(monkeypatch):
    from causal_gen_tpu.data.loader import Loader as JLoader
    from causal_gen_tpu.eval import cf_eval as jev
    from causal_gen_tpu_torch.data.loader import Loader
    from causal_gen_tpu_torch.eval import cf_eval as tev

    jdscm, vae_params, frozen, tdscm, rec = _eval_pair(monkeypatch)
    jl = JLoader(datasets(port=False)["test"], 6, shuffle=False, concat_pa=False)
    tds = datasets()
    tl = Loader(tds["test"], 6, shuffle=False, concat_pa=False)
    train_attrs = {k: np.asarray(v) for k, v in tds["train"].attrs.items()}
    ref = jev.eval_cf_loop(jdscm.cfg, jdscm.vae, vae_params, jdscm.pgm, frozen["pgm"],
                           jdscm.predictor, frozen["predictor"], jl, train_attrs, seeds=(0, 1),
                           measure=False)
    draws = rec.torch_noise()
    assert len(draws) == 8  # each seed's sweep traces its own program: 4 draws each
    runs = [tev.eval_counterfactuals(tdscm.cfg, tdscm.vae, tdscm.pgm, tdscm.predictor, tl,
                                     train_attrs, "cpu", seed=s, measure=False,
                                     noise=[draws[4 * s: 4 * s + 4]] * len(tl))
            for s in (0, 1)]
    for k, (mean, std) in ref.items():
        vals = [r[k] for r in runs]
        assert float(np.mean(vals)) == pytest.approx(mean, rel=1e-4, abs=1e-6), k
        assert float(np.std(vals)) == pytest.approx(std, rel=1e-3, abs=1e-5), k


def test_cli_train_cf_epochs_resume_and_best_link(tmp_path):
    from causal_gen_tpu_torch.cli import train_cf

    paths, _ = _write_checkpoints(tmp_path)
    ds = datasets(n_train=16, n_eval=8)
    save = str(tmp_path / "cf")
    base = ["--pgm_path", paths["pgm"], "--predictor_path", paths["aux"], "--vae_path",
            paths["vae"], "--device", "cpu", "--bs", "4", "--max_batches", "2",
            "--save_dir", save, "--lr", "1e-3", "--elbo_constraint", "5.5",
            "--thickness_weight", "1.0", "--intensity_weight", "0.05"]
    state, hist = train_cf.main(base + ["--epochs", "2"], datasets=ds)
    assert state.step + state.skipped == 4
    assert {f"valid_do_{k}/loss" for k in DAG + (None,)} <= set(hist)
    link = os.path.join(save, "checkpoint")
    with open(os.path.join(save, "index.json")) as f:
        entries = json.load(f)["entries"]
    assert len(entries) == 2 and entries[-1]["metric"] == pytest.approx(hist["valid_do_None/loss"])
    best = min(entries, key=lambda e: e["metric"])
    assert os.path.islink(link) and os.readlink(link) == os.path.basename(best["path"])
    with open(entries[-1]["path"] + ".meta.json") as f:
        meta = json.load(f)
    a, b = meta["config"]["thickness_calib"]
    assert meta["extra"] == {"epoch": 2} and (a, b) != (1.0, 0.0)  # fitted on train images

    # resume the last save for one more epoch: counters, optimizers and the
    # calibration carry on
    state2, _ = train_cf.main(base + ["--epochs", "3", "--resume", entries[-1]["path"]],
                              datasets=ds)
    assert state2.step + state2.skipped == 6
    assert state2.optimizer.state_dict()["state"][0]["step"].item() == state2.step
    with open(os.path.join(save, "index.json")) as f:
        last = json.load(f)["entries"][-1]
    with open(last["path"] + ".meta.json") as f:
        meta = json.load(f)
    assert meta["extra"] == {"epoch": 3} and meta["config"]["thickness_calib"] == [a, b]
    log = open(os.path.join(save, "trainlog.txt")).read()
    assert "resuming from" in log and "cf panel failed" not in log
    # the counterfactual panel of each evaluation (matplotlib is installed here)
    assert all(os.path.exists(os.path.join(save, f"cf_panel_{e}.png")) for e in (1, 2, 3))
