"""The port's data path against the JAX package's: the IDX reader, the
Morpho-MNIST and Colour-MNIST datasets, and the loaders. Datasets are small
synthetic files in the on-disk formats; for one seed, every batch of two
epochs must be identical (exact, uint8 and float32)."""

import gzip
import os
import struct

import numpy as np
import pytest

from causal_gen_tpu.config import get_config as jget
from causal_gen_tpu.data.datasets import setup_datasets as jsetup_datasets
from causal_gen_tpu.data.idx import load_idx as jload_idx
from causal_gen_tpu.data.loader import setup_loaders as jsetup_loaders
from causal_gen_tpu_torch.config import get_config as tget
from causal_gen_tpu_torch.data.augment import gather_crop_flip
from causal_gen_tpu_torch.data.datasets import setup_datasets
from causal_gen_tpu_torch.data.idx import load_idx
from causal_gen_tpu_torch.data.loader import Loader, PrefetchLoader, setup_loaders


def write_idx(path, a):
    codes = {np.dtype(np.uint8): 0x08}
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, codes[a.dtype], a.ndim))
        f.write(struct.pack(">" + "I" * a.ndim, *a.shape))
        f.write(a.tobytes())


def write_morphomnist(root, n_train=40, n_test=24, seed=0):
    rng = np.random.default_rng(seed)
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        write_idx(os.path.join(root, f"{prefix}-images-idx3-ubyte.gz"),
                  rng.integers(0, 256, (n, 28, 28)).astype(np.uint8))
        write_idx(os.path.join(root, f"{prefix}-labels-idx1-ubyte.gz"),
                  rng.integers(0, 10, n).astype(np.uint8))
        with open(os.path.join(root, f"{prefix}-morpho.csv"), "w") as f:
            f.write("index,area,length,thickness,slant,width,height,intensity\n")
            for i in rng.permutation(n):  # rows in file order, not index order
                f.write(f"{i},1,2,{rng.uniform(0.9, 6.2):.6f},0,3,4,{rng.uniform(67, 254):.6f}\n")


def write_cmnist(root, n_train=40, n_test=24, seed=0):
    rng = np.random.default_rng(seed)
    for sub, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, sub))
        np.save(os.path.join(root, sub, "images.npy"),
                rng.integers(0, 256, (n, 3, 28, 28)).astype(np.uint8))  # NCHW on disk
        np.save(os.path.join(root, sub, "parents.npy"),
                {"digit": rng.integers(0, 10, n), "colour": rng.integers(0, 10, n)})


def test_idx_reader_matches_jax(tmp_path):
    a = np.random.default_rng(1).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    path = str(tmp_path / "a-idx3-ubyte.gz")
    write_idx(path, a)
    np.testing.assert_array_equal(load_idx(path), a)
    np.testing.assert_array_equal(load_idx(path), jload_idx(path))


@pytest.mark.parametrize("name,writer,overrides", [
    ("morphomnist", write_morphomnist, {}),
    ("cmnist", write_cmnist, {"corrupt_p": 0.25}),
])
def test_loader_batches_match_jax(tmp_path, name, writer, overrides):
    writer(str(tmp_path))
    kw = dict(data_dir=str(tmp_path), seed=3, **overrides)
    jds = jsetup_datasets(jget(name, **kw))
    tds = setup_datasets(tget(name, **kw))
    assert sorted(jds) == sorted(tds)
    for split in jds:
        np.testing.assert_array_equal(tds[split].images, jds[split].images)
        np.testing.assert_array_equal(tds[split].pa, jds[split].pa)
    jl = jsetup_loaders(jds, 8, seed=3)
    tl = setup_loaders(tds, 8, seed=3)
    for split in ("train", "valid"):
        assert len(tl[split]) == len(jl[split])
        for epoch in range(2):
            jb, tb = list(jl[split]), list(tl[split])
            assert len(jb) == len(tb) > 0
            for a, b in zip(jb, tb):
                assert a["x"].dtype == b["x"].dtype == np.uint8
                assert b["x"].shape[1:3] == (32, 32)
                np.testing.assert_array_equal(b["x"], a["x"])
                np.testing.assert_array_equal(b["pa"], a["pa"])


def test_crop_flip_matches_jax_numpy_path():
    """The batch assembly against the JAX package's numpy augmentations
    (random_crop, then random_hflip), which draw as its native pass does
    whenever the padded image is larger than the crop."""
    from causal_gen_tpu.data import augment as jaug

    images = np.random.default_rng(4).integers(0, 256, (20, 28, 28, 3)).astype(np.uint8)
    idx = np.array([3, 1, 4, 1, 5, 9, 2, 6])
    for pad, hflip in ((4, 0.0), (2, 0.5)):
        r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
        got = gather_crop_flip(images, idx, r1, (30, 30), (pad, pad), hflip)
        want = jaug.random_hflip(r2, jaug.random_crop(r2, images[idx], (30, 30), (pad, pad)),
                                 hflip)
        np.testing.assert_array_equal(got, want)


def test_prefetch_loader_is_the_loader_in_order():
    from causal_gen_tpu_torch.data.datasets import ArrayDataset

    rng = np.random.default_rng(5)
    ds = ArrayDataset(images=rng.integers(0, 256, (30, 4, 4, 1)).astype(np.uint8),
                      attrs={"a": rng.normal(size=30).astype(np.float32)}, columns=("a",))
    plain = [b["x"] for b in Loader(ds, 4, seed=9)]
    fetched = [b["x"] for b in PrefetchLoader(Loader(ds, 4, seed=9))]
    assert len(plain) == len(fetched) == 7
    for a, b in zip(plain, fetched):
        np.testing.assert_array_equal(a, b)
    it = iter(PrefetchLoader(Loader(ds, 4, seed=9)))  # a consumer that stops early
    next(it)
    it.close()


def test_unported_datasets_refuse():
    """Every registry dataset is ported (vol3d last); a config naming no
    dataset of the port is refused."""
    with pytest.raises(NotImplementedError):
        setup_datasets(tget("morphomnist").replace(name="celeba64"))
