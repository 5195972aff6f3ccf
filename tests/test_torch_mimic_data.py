"""The MIMIC-CXR reader against the JAX package's on a synthetic
meta/<split>.csv + data/*.png tree (built as tests/test_datasets_synth.py's
mimic_tree builds it: rows of No Finding, Pleural Effusion and another
disease, 64x64 PNGs resized to input_res), and cli.main taking two steps of
the mimic192 config (bf16, reduced depth and width) on that tree on the CPU.
Images and attributes are compared exactly.
"""

import csv
import os

import numpy as np
import pytest
import torch
from PIL import Image

from causal_gen_tpu.config import get_config as jget
from causal_gen_tpu_torch.config import get_config as tget

from tests.test_torch_ukbb_pgm import ARCH

torch.set_num_threads(1)

RES = ARCH["input_res"]
PARENTS = ("age", "race", "sex", "finding")


@pytest.fixture
def mimic_tree(tmp_path):
    rng = np.random.default_rng(1)
    root = tmp_path / "mimic"
    (root / "meta").mkdir(parents=True)
    (root / "data").mkdir()
    rows = []
    for i in range(12):
        name = f"img_{i}.png"
        Image.fromarray(rng.integers(0, 256, (64, 64), dtype=np.uint8)).save(root / "data" / name)
        rows.append({"path_preproc": name,
                     "disease": ("Pleural Effusion", "No Finding", "Other")[i % 3],
                     "age": float(rng.uniform(20, 90)), "sex_label": int(rng.integers(0, 2)),
                     "race_label": int(rng.integers(0, 3))})
    for split in ("train", "valid", "test"):
        with open(root / "meta" / f"{split}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return str(root)


def test_mimic_reader_matches_jax(mimic_tree):
    from causal_gen_tpu.data.datasets import setup_datasets as jsetup
    from causal_gen_tpu_torch.data.datasets import setup_datasets as tsetup

    kw = dict(input_res=RES, parents_x=PARENTS, context_dim=6)
    ref, got = jsetup(jget("mimic192", **kw), mimic_tree), tsetup(tget("mimic192", **kw),
                                                                 mimic_tree)
    assert sorted(ref) == sorted(got) == ["test", "train", "valid"]
    for split in ref:
        r, g = ref[split], got[split]
        # the "Other" rows are left out (reference datasets.py:449-453)
        assert g.images.dtype == np.uint8 and g.images.shape == (8, RES, RES, 1)
        np.testing.assert_array_equal(g.images, r.images)
        assert g.columns == tuple(r.columns) == PARENTS
        for k in PARENTS:
            assert g.attrs[k].dtype == np.float32
            np.testing.assert_array_equal(g.attrs[k], np.asarray(r.attrs[k], np.float32), k)
        np.testing.assert_array_equal(g.pa, r.pa)
        assert g.pa.shape == (8, 6) and g.aug is None
        assert set(np.unique(g.attrs["finding"])) == {0.0, 1.0}


def test_cli_main_trains_mimic192_on_cpu(mimic_tree, tmp_path):
    from causal_gen_tpu_torch.cli import main as cli

    argv = ["--hps", "mimic192", "--device", "cpu", "--data_dir", mimic_tree,
            "--save_dir", str(tmp_path), "--epochs", "1", "--eval_freq", "1",
            "--max_batches", "2", "--bs", "2"]
    for k, v in ARCH.items():
        argv += [f"--{k}", *map(str, v)] if isinstance(v, tuple) else [f"--{k}", str(v)]
    state, history = cli.main(argv)
    assert state.step + state.skipped == 2
    assert state.model.cfg.dtype == "bfloat16" and state.model.cfg.context_dim == 6
    assert all(np.isfinite(history[k]) for k in ("train_elbo", "valid_elbo"))
    assert os.path.exists(os.path.join(str(tmp_path), "checkpoint.meta.json"))
