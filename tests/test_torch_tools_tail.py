"""The twins of the last JAX tools, on the CPU:

- tools/mfu_torch.py: the FLOPs FlopCounterMode gives one train step of a
  small Morpho-MNIST HVAE equal a count made by hand from the shapes of the
  convolutions and the head's contraction the step runs: 2 N Co Ho Wo Ci k^2
  a conv forward, and as much again for each of the input's and the
  weight's gradients where autograd computes it (exact: integers);
- tools/export_eval_ckpt_torch.py: the EMA copy of a VAE and of a CF
  checkpoint holds the EMA alone, and cli.evaluate prints exactly the same
  metrics from it as from the full checkpoint;
- tools/make_cmnist_torch.py: the same tree as tools/make_cmnist.py, byte for
  byte, from a small IDX slice.
"""

import gzip
import importlib.util
import json
import math
import os
import pathlib
import struct

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from causal_gen_tpu_torch.models.hvae import HVAE
from causal_gen_tpu_torch.train.state import init_train_state

from tests.test_torch_cf_eval import _write_checkpoints, datasets
from tests.torch_parity import small_morpho_cfg

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ContractionShapes(TorchFunctionMode):
    """Records the forward FLOPs of each conv and einsum a step calls, and
    the backward FLOPs autograd will spend on it."""

    def __init__(self):
        super().__init__()
        self.forward = self.backward = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in (torch.conv2d, torch.nn.functional.conv2d):
            x, w = args[0], args[1]
            groups = args[6] if len(args) > 6 else kwargs.get("groups", 1)
            n, co, ho, wo = out.shape
            flops = 2 * n * co * ho * wo * (w.shape[1] * w.shape[2] * w.shape[3])
            assert groups == 1
            self.add(flops, x, w)
        elif func is torch.einsum:
            eq, a, b = args[0], args[1], args[2]
            assert eq == "bc...,co->bo...", eq
            flops = 2 * math.prod(out.shape) * a.shape[1]
            self.add(flops, a, b)
        return out

    def add(self, flops, x, w):
        self.forward += flops
        self.backward += flops * (int(x.requires_grad) + int(w.requires_grad))


@pytest.mark.parametrize("overrides", [{}, {"cond_prior": True}, {"bs": 3, "z_dim": 6}])
def test_mfu_flops_match_a_hand_count(overrides):
    mfu = tool("mfu_torch")
    cfg = small_morpho_cfg(False).replace(**overrides)
    model = HVAE(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = init_train_state(cfg, model)
    batch = mfu.synth_batch(cfg, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    flops = mfu.step_flops(cfg, state, batch, gen)

    from causal_gen_tpu_torch.train.vae_trainer import train_step

    gen = torch.Generator().manual_seed(1)
    with ContractionShapes() as hand:
        train_step(cfg, state, batch, generator=gen)
    assert hand.forward > 0 and hand.backward > hand.forward
    assert flops == hand.forward + hand.backward


def test_mfu_peaks_follow_the_dtype_and_tf32(monkeypatch):
    mfu = tool("mfu_torch")
    assert mfu.H100_PEAK_FLOPS == {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
    cfg = small_morpho_cfg(False)
    assert mfu.peak_key(cfg.replace(dtype="bfloat16")) == "bfloat16"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert mfu.peak_key(cfg) == "float32"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert mfu.peak_key(cfg) == "tf32"


def test_mfu_measure_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool("mfu_torch").measure(small_morpho_cfg(False), windows=1, iters=1)


def same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("kind", ["vae", "cf"])
def test_exported_checkpoint_evaluates_as_the_full_one(tmp_path, capsys, kind):
    from causal_gen_tpu_torch.cli import evaluate
    from causal_gen_tpu_torch.pgm import train_cf as tcf

    export = tool("export_eval_ckpt_torch").export
    paths, tdscm = _write_checkpoints(tmp_path)
    with torch.no_grad():  # EMA weights that differ from the parameters
        for p in tdscm.vae.parameters():
            p.mul_(0.95)
    base = ["--pgm_path", paths["pgm"], "--predictor_path", paths["aux"], "--device", "cpu",
            "--bs", "4", "--seeds", "0"]
    if kind == "vae":
        from causal_gen_tpu_torch.train.checkpoint import state_payload, write_payload

        full = str(tmp_path / "vae_full.pt")
        state = init_train_state(tdscm.cfg, tdscm.vae)
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(0.01)
        write_payload(full, state_payload(state), {"config": tdscm.cfg.to_dict(),
                                                   "extra": {"best_loss": 5.5}})
        argv = lambda p: base + ["--vae_path", p]  # noqa: E731
        keep = {"ema_params", "step", "ema_updates", "skipped"}
    else:
        state = tcf.init_cf_state(tcf.CFConfig(elbo_constraint=5.5), tdscm)
        with torch.no_grad():
            for p in state.ema.vae.parameters():
                p.mul_(0.9)
        full = str(tmp_path / "cf_full.pt")
        tcf.save_cf_checkpoint(full, tcf.CFConfig(elbo_constraint=5.5), state,
                               extra={"epoch": 3})
        argv = lambda p: base + ["--vae_path", paths["vae"], "--cf_path", p]  # noqa: E731
        keep = {"ema_vae", "ema_lmbda", "step", "ema_updates", "skipped"}
    slim = export(full, str(tmp_path / "eval"), kind)
    assert slim == str(tmp_path / "eval" / "checkpoint")

    payload, ref = (torch.load(p, map_location="cpu", weights_only=True) for p in (slim, full))
    assert sorted(payload) == sorted(ref)
    for k in payload:
        if k in keep:
            assert same(payload[k], ref[k]), k
        else:
            assert payload[k] == {}, k
    assert os.path.getsize(slim) < os.path.getsize(full)
    with open(slim + ".meta.json") as f, open(full + ".meta.json") as g:
        meta, ref_meta = json.load(f), json.load(g)
    assert meta["config"] == ref_meta["config"] and meta["extra"]["eval_grade"] is True

    got = evaluate.main(argv(slim), datasets=datasets())
    want = evaluate.main(argv(full), datasets=datasets())
    capsys.readouterr()
    assert got == want


def test_export_refuses_another_kind(tmp_path):
    from causal_gen_tpu_torch.pgm import train_cf as tcf

    _, tdscm = _write_checkpoints(tmp_path)
    full = str(tmp_path / "cf_full.pt")
    tcf.save_cf_checkpoint(full, tcf.CFConfig(), tcf.init_cf_state(tcf.CFConfig(), tdscm))
    with pytest.raises(ValueError, match="not a vae checkpoint"):
        tool("export_eval_ckpt_torch").export(full, str(tmp_path / "eval"), "vae")


def write_idx(path, a):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, a.ndim))
        f.write(struct.pack(">" + "I" * a.ndim, *a.shape))
        f.write(a.tobytes())


@pytest.mark.parametrize("seed", [0, 3])
def test_make_cmnist_matches_the_jax_tool(tmp_path, seed):
    rng = np.random.default_rng(11)
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    write_idx(str(mnist / "t10k-images-idx3-ubyte.gz"),
              rng.integers(0, 256, (50, 28, 28)).astype(np.uint8))
    write_idx(str(mnist / "t10k-labels-idx1-ubyte.gz"), rng.integers(0, 10, 50).astype(np.uint8))
    outs = {}
    for name in ("make_cmnist", "make_cmnist_torch"):
        out = tmp_path / name
        mod = tool(name)
        argv = ["--mnist_dir", str(mnist), "--out_dir", str(out), "--seed", str(seed)]
        if name == "make_cmnist":
            import sys
            from unittest import mock

            with mock.patch.object(sys, "argv", ["make_cmnist.py"] + argv):
                mod.main()
        else:
            mod.main(argv)
        outs[name] = out
    files = sorted(p.relative_to(outs["make_cmnist"]) for p in outs["make_cmnist"].rglob("*.npy"))
    assert [str(p) for p in files] == ["test/images.npy", "test/parents.npy",
                                       "train/images.npy", "train/parents.npy"]
    for rel in files:
        assert (outs["make_cmnist_torch"] / rel).read_bytes() == \
            (outs["make_cmnist"] / rel).read_bytes(), rel
    images = np.load(outs["make_cmnist_torch"] / "train" / "images.npy")
    assert images.shape == (50, 28, 28, 3) and images.dtype == np.uint8
