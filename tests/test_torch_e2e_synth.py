"""``tools/e2e_synth_torch.py``, the port's twin of ``tools/e2e_synth.py``.

- Its tree builders write the JAX tool's CSV rows (the same values) and PNG
  pixels (exactly) for one seed; the JAX tool is imported by path (numpy at
  module top).
- The in-memory datasets it hands the CLIs where PIL is missing equal what
  the readers build from the tree, for each stage's data config.
- It runs stages 1234 on the tiny UK Biobank arch on the CPU (8 per split,
  bs 4, one batch an epoch), each stage reading the checkpoint the one
  before wrote; ``examples/counterfactual_demo_torch.py`` then draws its
  panel from the three checkpoints.
"""

import csv
import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

from causal_gen_tpu_torch.config import get_config
from causal_gen_tpu_torch.data import datasets as tds

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


twin = _tool("e2e_synth_torch")


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    """{relative path: CSV rows as dicts of floats or strings | PNG pixels}."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".png"):
                out[rel] = np.asarray(Image.open(path))
            else:
                with open(path, newline="") as fh:
                    rows = list(csv.DictReader(fh))

                def value(v):
                    try:
                        return float(v)
                    except ValueError:
                        return v

                out[rel] = [{k: value(v) for k, v in r.items()} for r in rows]
    return out


@pytest.mark.parametrize("dataset", ["ukbb", "mimic"])
def test_trees_are_the_jax_tool_s(tmp_path, dataset):
    jtool = _tool("e2e_synth")
    make = f"make_{dataset}_tree"
    getattr(jtool, make)(str(tmp_path / "jax"), n_per_split=3, n_train=4)
    getattr(twin, make)(str(tmp_path / "port"), n_per_split=3, n_train=4)
    ref, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(ref) == sorted(got) and len(ref) == 3 + 10
    for k in ref:
        if k.endswith(".png"):
            np.testing.assert_array_equal(got[k], ref[k])
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize("dataset", ["ukbb", "mimic"])
def test_in_memory_datasets_are_the_readers(tmp_path, dataset):
    root = str(tmp_path / "tree")
    if dataset == "ukbb":
        twin.make_ukbb_tree(root, n_per_split=3)
        tables = twin.ukbb_tables(3)
        cfgs = [get_config("ukbb192", data_dir=root),
                get_config("ukbb192", data_dir=root, context_norm="raw",
                           parents_x=tuple(twin.PGM_VARS["ukbb"]))]
    else:
        twin.make_mimic_tree(root, n_per_split=3)
        tables = twin.mimic_tables(3)
        cfgs = [get_config("mimic192", data_dir=root, input_res=64)]
    for cfg in cfgs:
        ref = tds.setup_datasets(cfg)
        got = twin.in_memory(tables)(cfg)
        assert sorted(got) == sorted(ref)
        for split in ref:
            np.testing.assert_array_equal(got[split].images, ref[split].images)
            np.testing.assert_array_equal(got[split].pa, ref[split].pa)
            assert got[split].columns == ref[split].columns and got[split].aug == ref[split].aug


def test_runs_the_four_stages_on_the_cpu(tmp_path, capsys):
    root, out = str(tmp_path / "tree"), str(tmp_path / "out")
    result = twin.main(["--dataset", "ukbb", "--root", root, "--out", out, "--device", "cpu",
                        "--n", "8", "--bs", "4", "--epochs", "1", "--max_batches", "1",
                        "--cf_max_batches", "1", "--eval_seeds", "0"])
    assert sorted(result["seconds"]) == ["1", "2", "3", "4"]
    assert sum(result["updates"]["1"]) == sum(result["updates"]["3"]) == 1  # made + skipped
    for stage in ("vae", "pgm", "aux", "cf"):  # each stage's checkpoint, read by the next
        assert os.path.exists(os.path.join(out, stage, "checkpoint")), stage
    log = capsys.readouterr().out
    assert "evaluating the CF fine-tuned VAE of " + os.path.join(out, "cf", "checkpoint") in log
    metrics = result["eval"]["metrics"]
    assert {"brain_volume_mae", "ventricle_volume_mae", "sex_acc"} <= set(metrics)
    assert all(np.isfinite(m["mean"]) for m in metrics.values())

    # the counterfactual demo on the three checkpoints: a panel of 3 images
    # under do(brain_volume), with the variance map of 2 particles
    demo = _example("counterfactual_demo_torch")
    panel = str(tmp_path / "panel.png")
    out = demo.main(["--pgm_path", os.path.join(out, "pgm", "checkpoint"),
                     "--predictor_path", os.path.join(out, "aux", "checkpoint"),
                     "--vae_path", os.path.join(out, "vae", "checkpoint"), "--data_dir", root,
                     "--device", "cpu", "--do", "brain_volume=0.3", "--n", "3",
                     "--particles", "2", "--out", panel])
    assert os.path.exists(panel) and out["cfs"]["x"].shape == (3, 1, 64, 64)
    assert torch.all(out["cfs"]["brain_volume"] == 0.3) and out["var_cf_x"] is not None
