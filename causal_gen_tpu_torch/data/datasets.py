"""Datasets of the training path: Morpho-MNIST, Colour-MNIST, UK Biobank,
MIMIC-CXR and the synthetic 3-D volumes.

Counterpart of ``causal_gen_tpu/data/datasets.py`` (reference src/datasets.py
MorphoMNIST 202-304, ColourMNIST 307-389, UKBB 22-135, MIMIC 392-531; the
volumes have no reference counterpart). Each dataset is held as contiguous
numpy arrays (uint8 NHWC images, NDHWC volumes, and float32 parents); a batch
is {"x": uint8 (B,H,W,C), "pa": float32 (B, context_dim)} with the parents in
``cfg.parents_x`` order (digit, colour and race one-hot).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from causal_gen_tpu_torch.config import Config
from causal_gen_tpu_torch.data import augment
from causal_gen_tpu_torch.data.idx import load_idx
from causal_gen_tpu_torch.utils.normalization import (
    MORPHOMNIST_MIN_MAX,
    get_attr_max_min,
    log_standardize,
    normalize,
)


def one_hot_np(x: np.ndarray, num_classes: int) -> np.ndarray:
    return np.eye(num_classes, dtype=np.float32)[np.asarray(x, np.int64)]


@dataclass
class ArrayDataset:
    """In-memory dataset: images and named parent attributes.

    ``attrs`` values are float32, (N,) for scalars and (N, K) for one-hots;
    ``columns`` fixes the pa concatenation order. ``aug`` is
    ("random_crop_flip", (out_h, out_w), (pad_h, pad_w), hflip_p),
    ("center_pad", pad) or None.
    """

    images: np.ndarray  # (N, H, W, C) uint8
    attrs: Dict[str, np.ndarray]
    columns: Tuple[str, ...]
    aug: Optional[Tuple] = None

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def pa(self) -> np.ndarray:
        """(N, context_dim) parents concatenated in ``columns`` order."""
        cols = [self.attrs[k][:, None] if self.attrs[k].ndim == 1 else self.attrs[k]
                for k in self.columns]
        return np.concatenate(cols, axis=1).astype(np.float32)

    def batch(self, idx: np.ndarray, rng: Optional[np.random.Generator] = None,
              concat_pa: bool = True) -> Dict[str, np.ndarray]:
        """{"x", "pa"}, or with ``concat_pa=False`` {"x", <each column>}: the
        parents one by one, (B, 1) or (B, K) float32, as the PGM trainer
        reads them (causal_gen_tpu/data/datasets.py:96-103)."""
        rng = rng if rng is not None else np.random.default_rng(0)
        if self.aug is not None and self.aug[0] == "random_crop_flip":
            _, size, padding, hflip_p = self.aug
            x = augment.gather_crop_flip(self.images, idx, rng, size, padding, hflip_p)
        elif self.aug is not None and self.aug[0] == "center_pad":
            x = augment.center_pad(self.images[idx], self.aug[1])
        else:
            x = self.images[idx]
        if concat_pa:
            return {"x": x, "pa": self.pa[idx]}
        out = {"x": x}
        for k in self.columns:
            v = self.attrs[k][idx]
            out[k] = (v[:, None] if v.ndim == 1 else v).astype(np.float32)
        return out


# ---------------------------------------------------------------------------
# Morpho-MNIST (reference datasets.py:202-304)
# ---------------------------------------------------------------------------


def _morphomnist_paths(root: str, train: bool) -> Tuple[str, str, str]:
    prefix = "train" if train else "t10k"
    return (os.path.join(root, f"{prefix}-images-idx3-ubyte.gz"),
            os.path.join(root, f"{prefix}-labels-idx1-ubyte.gz"),
            os.path.join(root, f"{prefix}-morpho.csv"))


def _read_columns(path: str, columns: List[str]) -> Dict[str, np.ndarray]:
    """The named float columns of a morphometrics CSV, in file order."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {k: np.array([float(r[k]) for r in rows], np.float32) for k in columns}


def load_morphomnist(root: str, train: bool, columns: List[str]
                     ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    img_p, lab_p, met_p = _morphomnist_paths(root, train)
    return load_idx(img_p), load_idx(lab_p), _read_columns(met_p, columns)


def morphomnist(cfg: Config, data_dir: Optional[str] = None) -> Dict[str, ArrayDataset]:
    """train/valid/test (test == valid, reference datasets.py:297)."""
    root = data_dir or cfg.data_dir
    cols_not_digit = [c for c in cfg.parents_x if c != "digit"]

    def build(train: bool) -> ArrayDataset:
        images, labels, metrics = load_morphomnist(root, train, cols_not_digit)
        attrs: Dict[str, np.ndarray] = {}
        for k, v in metrics.items():
            lo, hi = MORPHOMNIST_MIN_MAX[k]
            if cfg.context_norm == "[-1,1]":
                v = normalize(v, x_min=lo, x_max=hi)
            elif cfg.context_norm == "[0,1]":
                v = normalize(v, x_min=lo, x_max=hi, zero_one=True)
            attrs[k] = v.astype(np.float32)
        attrs["digit"] = one_hot_np(labels, 10)
        return ArrayDataset(images=images[..., None], attrs=attrs, columns=tuple(cfg.parents_x))

    res = (cfg.input_res, cfg.input_res)
    have_train = os.path.exists(_morphomnist_paths(root, True)[0])
    train_ds = build(have_train)
    train_ds.aug = ("random_crop_flip", res, (cfg.pad, cfg.pad), 0.0)
    eval_ds = build(False)
    eval_ds.aug = ("center_pad", 2)
    return {"train": train_ds, "valid": eval_ds, "test": eval_ds}


# ---------------------------------------------------------------------------
# Colour-MNIST (reference datasets.py:307-389)
# ---------------------------------------------------------------------------


def cmnist(cfg: Config, data_dir: Optional[str] = None, corrupt_p: Optional[float] = None,
           seed: int = 0) -> Dict[str, ArrayDataset]:
    root = data_dir or cfg.data_dir
    corrupt_p = cfg.corrupt_p if corrupt_p is None else corrupt_p

    def build(train: bool) -> ArrayDataset:
        sub = os.path.join(root, "train" if train else "test")
        images = np.load(os.path.join(sub, "images.npy"))
        parents = np.load(os.path.join(sub, "parents.npy"), allow_pickle=True).item()
        digit = np.asarray(parents["digit"], np.int64)
        colour = np.asarray(parents["colour"], np.int64)
        if train and corrupt_p > 0:
            # move the first corrupt_p of a permutation to another class
            # (reference datasets.py:325-343)
            rng = np.random.default_rng(seed)
            n_c = int(corrupt_p * len(images))
            idx = rng.permutation(len(images))[:n_c]
            for arr in (digit, colour):
                shift = rng.integers(1, 10, size=n_c)  # never 0, so always changed
                arr[idx] = (arr[idx] + shift) % 10
        attrs = {"digit": one_hot_np(digit, 10), "colour": one_hot_np(colour, 10)}
        if images.ndim == 3:
            images = images[..., None]
        if images.shape[-1] not in (1, 3):  # NCHW on disk -> NHWC
            images = np.transpose(images, (0, 2, 3, 1))
        return ArrayDataset(images=images.astype(np.uint8), attrs=attrs,
                            columns=tuple(cfg.parents_x))

    res = (cfg.input_res, cfg.input_res)
    train_ds = build(True)
    train_ds.aug = ("random_crop_flip", res, (cfg.pad, cfg.pad), 0.0)
    eval_ds = build(False)
    eval_ds.aug = ("center_pad", 2)
    return {"train": train_ds, "valid": eval_ds, "test": eval_ds}


# ---------------------------------------------------------------------------
# UK Biobank brain MRI (reference datasets.py:22-135)
# ---------------------------------------------------------------------------


def _load_png_batch(paths: List[str], res: int) -> np.ndarray:
    """Grey PNGs as (N, res, res) uint8, each resized bilinearly by PIL
    where it is not res x res already."""
    from PIL import Image

    out = np.empty((len(paths), res, res), np.uint8)
    for i, p in enumerate(paths):
        img = Image.open(p)
        if img.size != (res, res):
            img = img.resize((res, res), Image.BILINEAR)
        out[i] = np.asarray(img, np.uint8)
    return out


def _ukbb_attr(v: np.ndarray, k: str, context_norm: str) -> np.ndarray:
    """Attribute ``k`` in ``context_norm``: the volumes and age to [-1, 1],
    [0, 1] or log-standard; anything else (``raw``) and the binary attributes
    as read."""
    if k in ("age", "brain_volume", "ventricle_volume"):
        hi, lo = get_attr_max_min(k)
        if context_norm == "[-1,1]":
            v = normalize(v, x_min=lo, x_max=hi)
        elif context_norm == "[0,1]":
            v = normalize(v, x_min=lo, x_max=hi, zero_one=True)
        elif context_norm == "log_standard":
            v = log_standardize(v)
    return v.astype(np.float32)


def _ukbb_png_name(row: Dict[str, str]) -> str:
    return (f"{int(float(row['eid']))}_"
            f"{'T1' if float(row['mri_seq']) == 0.0 else 'T2_FLAIR'}"
            "_unbiased_brain_rigid_to_mni.png")


def _read_csv(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


Tables = Dict[str, Tuple[List[Dict[str, Any]], np.ndarray]]  # split -> (rows, images)


def _at_res(images: np.ndarray, res: int) -> np.ndarray:
    if images.shape[1:3] != (res, res):
        raise ValueError(f"images of {images.shape[1:3]} for input_res {res}: resizing needs "
                         "the files (PIL)")
    return images


def ukbb_from_rows(cfg: Config, tables: Tables) -> Dict[str, ArrayDataset]:
    """UK Biobank datasets from each split's CSV rows (``brain_csv``'s
    columns, as strings or numbers) and its images, (N, res, res) uint8 at
    ``cfg.input_res``: the attributes of ``cfg.parents_x`` in
    ``cfg.context_norm``, the train split augmented."""
    res = cfg.input_res
    out = {}
    for split, (rows, images) in tables.items():
        columns = list(cfg.parents_x)
        attrs = {k: _ukbb_attr(np.array([float(r[k]) for r in rows], np.float32), k,
                               cfg.context_norm) for k in columns}
        ds = ArrayDataset(images=_at_res(images, res)[..., None], attrs=attrs,
                          columns=tuple(columns))
        if split == "train":
            # torchvision RandomCrop padding=[2*pad, pad]: left/right by 2*pad,
            # top/bottom by pad (reference datasets.py:106-109)
            ds.aug = ("random_crop_flip", (res, res), (cfg.pad, 2 * cfg.pad), cfg.hflip)
        out[split] = ds
    return out


def ukbb(cfg: Config, data_dir: Optional[str] = None) -> Dict[str, ArrayDataset]:
    """train/valid/test from ``brain_csv/<split>.csv`` and the 192x192 PNGs
    under ``thumbs_192x192/`` (reference datasets.py:22-135)."""
    root = data_dir or cfg.data_dir
    tables: Tables = {}
    for split in ("train", "valid", "test"):
        rows = _read_csv(os.path.join(root, "brain_csv", split + ".csv"))
        paths = [os.path.join(root, "thumbs_192x192", _ukbb_png_name(r)) for r in rows]
        tables[split] = (rows, _load_png_batch(paths, cfg.input_res))
    return ukbb_from_rows(cfg, tables)


# ---------------------------------------------------------------------------
# MIMIC-CXR (reference datasets.py:392-531)
# ---------------------------------------------------------------------------

MIMIC_DISEASES = ("No Finding", "Pleural Effusion")


def mimic_from_rows(cfg: Config, tables: Tables) -> Dict[str, ArrayDataset]:
    """MIMIC datasets from each split's ``meta`` CSV rows and their images,
    (N, res, res) uint8 at ``cfg.input_res``: the rows whose ``disease`` is
    "No Finding" or "Pleural Effusion"; age -> age / 100 * 2 - 1, race ->
    one-hot(3), sex as read, finding = Pleural Effusion."""
    out = {}
    for split, (rows, images) in tables.items():
        keep = [i for i, r in enumerate(rows) if r["disease"] in MIMIC_DISEASES]
        rows = [rows[i] for i in keep]
        attrs = {
            "age": np.array([float(r["age"]) for r in rows], np.float32) / 100 * 2 - 1,
            "sex": np.array([float(r["sex_label"]) for r in rows], np.float32),
            "race": one_hot_np([int(float(r["race_label"])) for r in rows], 3),
            "finding": np.array([r["disease"] == "Pleural Effusion" for r in rows],
                                np.float32),
        }
        out[split] = ArrayDataset(images=_at_res(images[keep], cfg.input_res)[..., None],
                                  attrs=attrs, columns=tuple(cfg.parents_x))
    return out


def mimic(cfg: Config, data_dir: Optional[str] = None) -> Dict[str, ArrayDataset]:
    """train/valid/test from ``meta/<split>.csv`` and the PNGs under ``data/``
    (causal_gen_tpu/data/datasets.py:277-314), each image resized bilinearly
    to ``input_res`` (``mimic_from_rows``). No augmentation, as in the JAX
    reader."""
    root = data_dir or cfg.data_dir
    tables: Tables = {}
    for split in ("train", "valid", "test"):
        rows = [r for r in _read_csv(os.path.join(root, "meta", split + ".csv"))
                if r["disease"] in MIMIC_DISEASES]
        paths = [os.path.join(root, "data", r["path_preproc"]) for r in rows]
        tables[split] = (rows, _load_png_batch(paths, cfg.input_res))
    return mimic_from_rows(cfg, tables)


# ---------------------------------------------------------------------------
# Synthetic 3-D volumes (causal_gen_tpu/data/datasets.py:318-370)
# ---------------------------------------------------------------------------

VOL3D_MIN_MAX = {"radius": (0.15, 0.40), "intensity": (96.0, 255.0)}


def make_vol3d(n: int, res: int, seed: int = 0) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Synthetic spheres with a causal parent pair, the JAX package's arrays
    for the same seed: radius ~ U(0.15, 0.40) (a fraction of the half-side),
    intensity = 255 - 300 (radius - 0.15) + N(0, 8) clipped to [96, 255];
    voxels intensity * sigmoid((radius - d) / s) about a jittered centre,
    s ~ one voxel, as uint8 (n, res, res, res, 1)."""
    rng = np.random.default_rng(seed)
    radius = rng.uniform(*VOL3D_MIN_MAX["radius"], size=n).astype(np.float32)
    intensity = 255.0 - 300.0 * (radius - 0.15) + rng.normal(0.0, 8.0, size=n)
    intensity = np.clip(intensity, *VOL3D_MIN_MAX["intensity"]).astype(np.float32)
    center = rng.uniform(-0.1, 0.1, size=(n, 3)).astype(np.float32)

    ax = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"))  # (3, res, res, res)
    sharp = 2.0 / res
    vols = np.empty((n, res, res, res, 1), np.uint8)
    for i in range(n):
        d = np.sqrt(((grid - center[i][:, None, None, None]) ** 2).sum(0))
        soft = 1.0 / (1.0 + np.exp(-(radius[i] - d) / sharp))
        vols[i, ..., 0] = np.clip(intensity[i] * soft, 0, 255).astype(np.uint8)
    return vols, {"radius": radius, "intensity": intensity}


def vol3d(cfg: Config, data_dir: Optional[str] = None) -> Dict[str, ArrayDataset]:
    """train/valid/test of 512/128/128 generated volumes (seeds cfg.seed,
    +1, +2), the parents scaled to [-1, 1]; no files, no augmentation."""

    def build(n: int, seed: int) -> ArrayDataset:
        vols, raw = make_vol3d(n, cfg.input_res, seed=seed)
        attrs = {k: normalize(v, x_min=VOL3D_MIN_MAX[k][0], x_max=VOL3D_MIN_MAX[k][1])
                 .astype(np.float32) for k, v in raw.items()}
        return ArrayDataset(images=vols, attrs=attrs, columns=tuple(cfg.parents_x))

    return {"train": build(512, cfg.seed), "valid": build(128, cfg.seed + 1),
            "test": build(128, cfg.seed + 2)}


DATASETS = {"morphomnist": morphomnist, "cmnist": cmnist, "ukbb": ukbb, "mimic": mimic,
            "vol3d": vol3d}


def setup_datasets(cfg: Config, data_dir: Optional[str] = None) -> Dict[str, ArrayDataset]:
    """Dataset dispatch on the config name's prefix (reference
    train_setup.py:16-28)."""
    for prefix, make in DATASETS.items():
        if cfg.name.startswith(prefix):
            return make(cfg, data_dir)
    raise NotImplementedError(f"no dataset for config '{cfg.name}' in the port yet "
                              f"(have {sorted(DATASETS)})")


def make_datasets(given, cfg: Config) -> Dict[str, ArrayDataset]:
    """The datasets a CLI runs on: ``given`` when it is a dict, ``given(cfg)``
    when it is a function of the run's data config (in-memory data, e.g.
    ``tools/e2e_synth_torch.py``'s), else the files ``cfg`` names."""
    if given is None:
        return setup_datasets(cfg)
    return given(cfg) if callable(given) else given
