#!/usr/bin/env python
"""Synthetic end-to-end run of the PyTorch port's three stages (HVAE -> PGM +
predictors -> DSCM counterfactual fine-tuning -> effectiveness evaluation)
for the UK Biobank and MIMIC dataset families.

The twin of ``tools/e2e_synth.py``: the same synthetic trees, drawn from the
same ground-truth SCM with numpy (attributes sampled, images rendered as
functions of them), and the same four stages with the same flags, driven
through the port's CLIs in one process (``causal_gen_tpu_torch.cli.main``,
``.train_pgm``, ``.train_cf``, ``.evaluate``), each stage loading the
checkpoint of the one before. Where PIL is missing the tree is not written:
each CLI gets the same rows and images in memory through its ``datasets=``
argument (``data/datasets.py::ukbb_from_rows``, ``mimic_from_rows``).

Usage (the card by default; ``--device cpu`` off it):
  python tools/e2e_synth_torch.py --dataset ukbb --root DIR --out DIR [--device cpu]
  python tools/e2e_synth_torch.py --dataset ukbb --flagship --n 16 --bs 8 --epochs 1 \
      --cf_max_batches 2 --eval_seeds 0
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# ---------------------------------------------------------------------------
# Synthetic data (the numpy draws of tools/e2e_synth.py, in its order)
# ---------------------------------------------------------------------------

SPLITS = ("train", "valid", "test")
UKBB_COLUMNS = ("eid", "mri_seq", "age", "brain_volume", "ventricle_volume", "sex")
MIMIC_COLUMNS = ("path_preproc", "disease", "age", "sex_label", "race_label")
Tables = Dict[str, Tuple[List[dict], np.ndarray]]  # split -> (CSV rows, uint8 images)


def _disk(res: int, cx: float, cy: float, r: float) -> np.ndarray:
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
    return ((xx - cx) ** 2 + (yy - cy) ** 2 <= r**2).astype(np.float32)


def ukbb_tables(n_per_split: int = 96, seed: int = 0, n_train: int = 0) -> Tables:
    """Brain-MRI-like rows and 192^2 images: a bright disk with radius ~
    brain_volume and a dark inner disk ~ ventricle_volume; T2 (mri_seq=1)
    is brighter. SCM: sex, age exogenous; bvol = f(sex, age); vvol =
    f(bvol, age)."""
    rng = np.random.default_rng(seed)
    eid = 1000
    out: Tables = {}
    for split in SPLITS:
        rows, images = [], []
        for _ in range(n_train if (split == "train" and n_train) else n_per_split):
            sex = float(rng.integers(0, 2))
            mri_seq = float(rng.integers(0, 2))
            age = float(rng.uniform(44, 73))
            bvol = float(np.clip(1.25e6 + 1.2e5 * sex - 4.5e3 * (age - 58)
                                 + rng.normal(0, 4e4), 9e5, 1.6e6))
            vvol = float(np.clip(3e4 + 0.04 * (bvol - 1.25e6) + 1.2e3 * (age - 58)
                                 + rng.normal(0, 6e3), 8e3, 1.55e5))
            res = 192
            r_b = 40 + 50 * (bvol - 9e5) / 7e5
            r_v = 4 + 28 * (vvol - 8e3) / 1.47e5
            img = _disk(res, 96, 96, r_b) * (140 + 60 * mri_seq)
            img -= _disk(res, 96, 96, r_v) * (110 + 40 * mri_seq)
            img += rng.normal(0, 6, (res, res))
            images.append(np.clip(img, 0, 255).astype(np.uint8))
            rows.append(dict(eid=eid, mri_seq=mri_seq, age=age, brain_volume=bvol,
                             ventricle_volume=vvol, sex=sex))
            eid += 1
        out[split] = (rows, np.stack(images))
    return out


def mimic_tables(n_per_split: int = 96, seed: int = 1, n_train: int = 0,
                 res: int = 64) -> Tables:
    """CXR-like rows and images: background brightness ~ age, a bright
    square marker if finding=1, left-third shading by race, a border stripe
    by sex."""
    rng = np.random.default_rng(seed)
    i = 0
    out: Tables = {}
    for split in SPLITS:
        rows, images = [], []
        for _ in range(n_train if (split == "train" and n_train) else n_per_split):
            sex = int(rng.integers(0, 2))
            race = int(rng.integers(0, 3))
            age = float(rng.uniform(20, 90))
            # finding depends on age (reference ChestPGM: finding | age)
            p_f = 1.0 / (1.0 + np.exp(-(age - 55) / 10))
            finding = int(rng.uniform() < p_f)
            img = np.full((res, res), 60 + age, np.float32)
            img[:, : res // 3] += 15 * race
            if sex:
                img[: max(4, res // 16), :] += 40.0
            if finding:
                img[3 * res // 8: 5 * res // 8, 3 * res // 8: 5 * res // 8] += 70.0
            img += rng.normal(0, 5, (res, res))
            images.append(np.clip(img, 0, 255).astype(np.uint8))
            rows.append(dict(path_preproc=f"img_{split}_{i}.png",
                             disease="Pleural Effusion" if finding else "No Finding",
                             age=age, sex_label=sex, race_label=race))
            i += 1
        out[split] = (rows, np.stack(images))
    return out


def _write_csv(path: str, columns: Sequence[str], rows: List[dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(columns)
        w.writerows([[r[k] for k in columns] for r in rows])


def _save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def make_ukbb_tree(root: str, n_per_split: int = 96, seed: int = 0, n_train: int = 0) -> None:
    """``brain_csv/<split>.csv`` and ``thumbs_192x192/*.png`` of ``ukbb_tables``."""
    os.makedirs(os.path.join(root, "brain_csv"), exist_ok=True)
    os.makedirs(os.path.join(root, "thumbs_192x192"), exist_ok=True)
    for split, (rows, images) in ukbb_tables(n_per_split, seed, n_train).items():
        for r, img in zip(rows, images):
            seq = "T1" if r["mri_seq"] == 0.0 else "T2_FLAIR"
            _save_png(os.path.join(root, "thumbs_192x192",
                                   f"{r['eid']}_{seq}_unbiased_brain_rigid_to_mni.png"), img)
        _write_csv(os.path.join(root, "brain_csv", f"{split}.csv"), UKBB_COLUMNS, rows)


def make_mimic_tree(root: str, n_per_split: int = 96, seed: int = 1, n_train: int = 0,
                    res: int = 64) -> None:
    """``meta/<split>.csv`` and ``data/*.png`` of ``mimic_tables``."""
    os.makedirs(os.path.join(root, "meta"), exist_ok=True)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    for split, (rows, images) in mimic_tables(n_per_split, seed, n_train, res).items():
        for r, img in zip(rows, images):
            _save_png(os.path.join(root, "data", r["path_preproc"]), img)
        _write_csv(os.path.join(root, "meta", f"{split}.csv"), MIMIC_COLUMNS, rows)


def in_memory(tables: Tables):
    """The ``datasets=`` function each CLI takes: its data config -> the
    datasets its reader would build from the tree of ``tables``."""
    from causal_gen_tpu_torch.data.datasets import mimic_from_rows, ukbb_from_rows

    def make(cfg):
        return (ukbb_from_rows if cfg.name.startswith("ukbb") else mimic_from_rows)(cfg, tables)

    return make


def have_pil() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


# ---------------------------------------------------------------------------
# Stage drivers (the port's CLI mains, in process)
# ---------------------------------------------------------------------------

TINY_ARCH = dict(
    ukbb=[
        "--input_res", "64",
        "--enc_arch", "64b1d2,32b1d2,16b1d2,8b1d2,4b1d4,1b1",
        "--dec_arch", "1b1,4b1,8b1,16b1,32b1,64b1",
        "--widths", "8", "8", "16", "16", "24", "24",
        "--z_dim", "4", "--bias_max_res", "64",
    ],
    mimic=[
        "--input_res", "64",
        "--enc_arch", "64b1d2,32b1d2,16b1d2,8b1d2,4b1d4,1b1",
        "--dec_arch", "1b1,4b1,8b1,16b1,32b1,64b1",
        "--widths", "8", "8", "16", "16", "24", "24",
        "--z_dim", "4", "--bias_max_res", "64",
    ],
)

PGM_VARS = dict(
    ukbb=["mri_seq", "age", "brain_volume", "ventricle_volume", "sex"],
    mimic=["age", "race", "sex", "finding"],
)


def run(dataset: str, root: str, out: str, epochs: int, bs: int, stages: str = "1234",
        flagship: bool = False, cf_epochs: int = 1, cf_bs: int = 0, cf_max_batches: int = 3,
        eval_freq: int = 1, vae_extra=(), cf_extra=(), device: str = "cuda",
        datasets=None, eval_seeds: Sequence[int] = (0, 1), max_batches: Optional[int] = None
        ) -> Dict[str, object]:
    """The stages of ``stages`` in order on the tree under ``root`` (or on
    ``datasets``, a ``datasets=`` function, e.g. ``in_memory``); the
    checkpoints go under ``out``. ``max_batches`` caps the batches of an
    epoch of stages 1 and 2. Returns the seconds of each stage, the updates
    made and skipped in stages 1 and 3, and stage 4's result."""
    from causal_gen_tpu_torch.cli import evaluate as eval_cli
    from causal_gen_tpu_torch.cli import main as vae_cli
    from causal_gen_tpu_torch.cli import train_cf as cf_cli
    from causal_gen_tpu_torch.cli import train_pgm as pgm_cli

    if flagship:
        # the reference's product configs at 192^2: ukbb192 (run_slurm.sh:
        # 22-37) and mimic192 (run_slurm.sh:39-52), bf16, stage_scan + remat
        hps, res = ("ukbb192" if dataset == "ukbb" else "mimic192"), 192
    else:
        hps, res = ("ukbb64" if dataset == "ukbb" else "mimic192"), 64
    dirs = {k: os.path.join(out, k) for k in ("vae", "pgm", "aux", "cf")}
    common = ["--device", device] + ([] if max_batches is None
                                     else ["--max_batches", str(max_batches)])
    seconds: Dict[str, float] = {}
    result: Dict[str, object] = {"seconds": seconds}

    def timed(stage: str, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        seconds[stage] = time.perf_counter() - t0
        return r

    updates: Dict[str, Tuple[int, int]] = {}  # stage -> (updates made, skipped)
    result["updates"] = updates
    if "1" in stages:
        print(f"== stage 1: HVAE ({hps}, {'registry' if flagship else 'tiny'} arch) ==",
              flush=True)
        state, _ = timed("1", _stage1, vae_cli, hps, root, dirs["vae"], epochs, bs, dataset,
                         flagship, eval_freq, list(vae_extra) + common, datasets)
        updates["1"] = (state.step, state.skipped)
    if "2" in stages:
        timed("2", _stage2, pgm_cli, dataset, root, dirs["pgm"], dirs["aux"], epochs, bs, res,
              common, datasets)
    if "3" in stages:
        state, _ = timed("3", _stage3, cf_cli, dataset, root, dirs, cf_bs or min(bs, 16),
                         cf_epochs, cf_max_batches, list(cf_extra) + ["--device", device],
                         flagship, datasets)
        updates["3"] = (state.step, state.skipped)
    if "4" in stages:
        cf_dir = dirs["cf"] if "3" in stages or os.path.exists(dirs["cf"]) else ""
        result["eval"] = timed("4", _stage4, eval_cli, root, dirs, cf_bs or bs, cf_dir,
                               device, datasets, eval_seeds)
    print(json.dumps({"e2e": dataset, "status": "ok", "out": out, "flagship": flagship,
                      "seconds": seconds, "updates": updates}), flush=True)
    return result


def _stage1(vae_cli, hps, root, vae_dir, epochs, bs, dataset, flagship, eval_freq, vae_extra,
            datasets):
    if flagship:
        ref_flags = (["--beta", "5", "--z_max_res", "96", "--wd", "0.05"] if dataset == "ukbb"
                     # mimic192 (run_slurm.sh:39-52): beta 9 and the z cap 96
                     else ["--beta", "9", "--z_max_res", "96", "--wd", "0.05"])
        # the flagships' remat: ukbb192 from 48^2 up, mimic192's GELU body
        # everywhere (checkpoints/*_flagship/vae/hparams.json)
        mr = "48" if dataset == "ukbb" else "0"
        argv = ["--hps", hps, "--data_dir", root, "--save_dir", vae_dir,
                "--epochs", str(epochs), "--eval_freq", str(eval_freq), "--bs", str(bs),
                "--viz_freq", "0", "--stage_scan", "--remat", "--remat_min_res", mr,
                # zero-initialised posterior heads: q == p at init, so the
                # first updates do not trip grad_skip (Config.posterior_init_scale)
                "--posterior_init_scale", "0.0", *ref_flags]
    else:
        argv = ["--hps", hps, "--data_dir", root, "--save_dir", vae_dir,
                "--epochs", str(epochs), "--eval_freq", "1", "--bs", str(bs),
                "--beta", "1.0", "--dtype", "float32", "--viz_freq", "0", *TINY_ARCH[dataset]]
    extra = list(vae_extra)
    # resume a stage 1 that stopped, instead of writing over its checkpoints
    ckpt = os.path.join(vae_dir, "checkpoint")
    if "--resume" not in extra and os.path.exists(ckpt + ".meta.json"):
        print(f"== stage 1: resuming from {ckpt} ==")
        extra += ["--resume", ckpt]
    return vae_cli.main(argv + extra, datasets=datasets)


def _pgm_common(dataset, root, epochs, bs, res):
    common = ["--dataset", dataset, "--data_dir", root, "--bs", str(bs), "--input_res", str(res),
              "--epochs", str(4 * epochs), "--lr", "5e-3", "--parents_x", *PGM_VARS[dataset]]
    if dataset == "ukbb":
        common += ["--context_norm", "raw"]
    return common


def _stage2(pgm_cli, dataset, root, pgm_dir, aux_dir, epochs, bs, res, extra, datasets):
    common = _pgm_common(dataset, root, epochs, bs, res) + list(extra)
    print("== stage 2a: PGM (sup_pgm) ==", flush=True)
    pgm_cli.main(["--setup", "sup_pgm", "--save_dir", pgm_dir, *common], datasets=datasets)
    print("== stage 2b: predictors (sup_aux) ==", flush=True)
    pgm_cli.main(["--setup", "sup_aux", "--save_dir", aux_dir, *common], datasets=datasets)


def _stage3(cf_cli, dataset, root, dirs, bs, cf_epochs, cf_max_batches, cf_extra, flagship,
            datasets):
    print("== stage 3: DSCM counterfactual fine-tuning ==", flush=True)
    argv = ["--pgm_path", os.path.join(dirs["pgm"], "checkpoint"),
            "--predictor_path", os.path.join(dirs["aux"], "checkpoint"),
            "--vae_path", os.path.join(dirs["vae"], "checkpoint"),
            "--data_dir", root, "--save_dir", dirs["cf"],
            "--epochs", str(cf_epochs), "--bs", str(bs), "--eval_freq", "1"]
    if flagship:
        # the reference CF launch (pgm/run.sh:25-37): a random DAG variable
        # is intervened on each step
        argv += ["--lr", "1e-4", "--wd", "0.1", "--alpha", "0.1"]
    else:  # a fixed intervention keeps the short run deterministic
        argv += ["--do_pa", "brain_volume" if dataset == "ukbb" else "finding"]
    if cf_max_batches:
        argv += ["--max_batches", str(cf_max_batches)]
    return cf_cli.main(argv + list(cf_extra), datasets=datasets)


def _stage4(eval_cli, root, dirs, bs, cf_dir, device, datasets, seeds):
    print("== stage 4: counterfactual effectiveness eval ==", flush=True)
    argv = ["--pgm_path", os.path.join(dirs["pgm"], "checkpoint"),
            "--predictor_path", os.path.join(dirs["aux"], "checkpoint"),
            "--vae_path", os.path.join(dirs["vae"], "checkpoint"),
            "--data_dir", root, "--bs", str(bs), "--max_batches", "2",
            "--seeds", *map(str, seeds), "--no_measure", "--device", device]
    if cf_dir and os.path.exists(os.path.join(cf_dir, "checkpoint")):
        argv += ["--cf_path", os.path.join(cf_dir, "checkpoint")]
    return eval_cli.main(argv, datasets=datasets)


def main(argv: Optional[list] = None) -> Dict[str, object]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", choices=["ukbb", "mimic"], required=True)
    p.add_argument("--root", default="", help="the synthetic tree (written when missing)")
    p.add_argument("--out", default="", help="the stages' checkpoints")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--in_memory", action="store_true",
                   help="hand the data to the CLIs in memory and write no tree (the default "
                        "where PIL is missing)")
    p.add_argument("--n", type=int, default=96)
    p.add_argument("--n_train", type=int, default=0, help="train-split size (0: --n)")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--max_batches", type=int, default=None,
                   help="cap the batches of an epoch of stages 1 and 2")
    p.add_argument("--flagship", action="store_true",
                   help="the full 192^2 registry configs (ukbb192 / mimic192) instead of the "
                        "tiny 64^2 arch")
    p.add_argument("--cf_epochs", type=int, default=1)
    p.add_argument("--cf_bs", type=int, default=0)
    p.add_argument("--cf_max_batches", type=int, default=3, help="0 = a full epoch")
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--eval_seeds", nargs="+", type=int, default=[0, 1])
    p.add_argument("--vae_extra", default="",
                   help="extra flags of the stage-1 CLI, one space-separated string")
    p.add_argument("--cf_extra", default="",
                   help="extra flags of the stage-3 CLI, e.g. --cf_extra='--cf_remat'")
    p.add_argument("--stages", default="1234",
                   help="the stages to run, e.g. '34' on existing stage-1/2 checkpoints")
    args = p.parse_args(argv)
    suffix = "192" if args.flagship else ""
    tmp = tempfile.gettempdir()
    root = args.root or os.path.join(tmp, f"synth_{args.dataset}{suffix}")
    out = args.out or os.path.join(tmp, f"e2e_torch_{args.dataset}{suffix}")
    res = 192 if args.flagship else 64
    tables = (ukbb_tables(args.n, n_train=args.n_train) if args.dataset == "ukbb"
              else mimic_tables(args.n, n_train=args.n_train, res=res))
    datasets = None
    if args.in_memory or not have_pil():
        datasets = in_memory(tables)
    elif not os.path.exists(root):
        print(f"building synthetic {args.dataset} tree at {root}", flush=True)
        if args.dataset == "ukbb":
            make_ukbb_tree(root, n_per_split=args.n, n_train=args.n_train)
        else:
            make_mimic_tree(root, n_per_split=args.n, n_train=args.n_train, res=res)
    return run(args.dataset, root, out, args.epochs, args.bs, stages=args.stages,
               flagship=args.flagship, cf_epochs=args.cf_epochs, cf_bs=args.cf_bs,
               cf_max_batches=args.cf_max_batches, eval_freq=args.eval_freq,
               vae_extra=args.vae_extra.split(), cf_extra=args.cf_extra.split(),
               device=args.device, datasets=datasets, eval_seeds=args.eval_seeds,
               max_batches=args.max_batches)


if __name__ == "__main__":
    main()
