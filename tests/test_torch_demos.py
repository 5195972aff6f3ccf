"""``examples/vol3d_demo_torch.py`` on a vol3d32 checkpoint that the port's
``cli.main`` writes (a narrow 8^3 arch, two steps on the CPU): the panel's
observation columns are the generated volumes' mid-slices, and each
do(radius) column is a decode of the same abducted latents."""

import functools
import importlib.util
import os

import numpy as np
import torch
from PIL import Image

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_vol3d_demo_renders_the_sweep(tmp_path, monkeypatch):
    from causal_gen_tpu_torch.cli import main as cli
    from causal_gen_tpu_torch.config import get_config
    from causal_gen_tpu_torch.data.datasets import make_vol3d

    monkeypatch.setattr(cli, "MetricWriter", functools.partial(cli.MetricWriter,
                                                               tensorboard=False))
    save = str(tmp_path / "vae")
    cli.main(["--hps", "vol3d32", "--device", "cpu", "--epochs", "1", "--max_batches", "2",
              "--eval_freq", "1", "--viz_freq", "0", "--bs", "2", "--input_res", "8",
              "--enc_arch", "8b1d2,4b1d4,1b1", "--dec_arch", "1b1,4b1,8b1",
              "--widths", "8", "8", "8", "--bias_max_res", "4", "--save_dir", save])
    spec = importlib.util.spec_from_file_location(
        "vol3d_demo_torch", os.path.join(ROOT, "examples", "vol3d_demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    out = str(tmp_path / "vol3d.png")
    im = demo.main(["--vae_path", os.path.join(save, "checkpoint"), "--device", "cpu",
                    "--n", "2", "--radii", "0.2", "0.3", "--out", out])
    assert im.shape == (2 * 2 * 8 + 8, 4 * 8)  # 2 volumes x (axial, sagittal); obs|rec|2 cfs
    np.testing.assert_array_equal(np.asarray(Image.open(out)), im)
    vols, _ = make_vol3d(2, 8, seed=get_config("vol3d32").seed + 1)  # the valid split's
    # the observation's mid-slices, through [-1, 1] and back (within 1)
    for got, ref in ((im[:8, :8], vols[0, 4, :, :, 0]),
                     (im[8 + 16:8 + 16 + 8, :8], vols[0, :, :, 4, 0])):
        assert np.abs(got.astype(int) - ref).max() <= 1
