"""The native augment pass of the port (causal_gen_tpu_torch/data/native.py):
built from native/augment.cpp into this host's build directory, never the
committed binary, and byte for byte equal to its plain numpy version
(data/augment.py::gather_crop_flip) and to the JAX package's pass
(causal_gen_tpu/data/native.py, where its committed library loads here) for
the same seed. ArrayDataset.batch runs it and gives the JAX package's
batches on a synthetic UK Biobank tree. Exact: uint8 outputs compared with
array_equal."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from causal_gen_tpu.config import get_config as jget
from causal_gen_tpu.data import native as jnative
from causal_gen_tpu_torch.config import get_config as tget
from causal_gen_tpu_torch.data import augment, native
from causal_gen_tpu_torch.utils.cache import setup_compilation_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent
RES = 32

# (n_src, h, w, c, n, out, padding, hflip): Morpho-MNIST's train crop (28^2
# padded to 32^2), ukbb192's (pad (p, 2p), hflip 0.5) at a small res, RGB
# Colour-MNIST, a batch large enough for the pass's thread pool, a single image
CASES = [(40, 28, 28, 1, 32, (32, 32), (2, 2), 0.0),
         (12, 24, 24, 1, 8, (24, 24), (3, 6), 0.5),
         (20, 28, 28, 3, 16, (28, 28), (4, 4), 0.5),
         (64, 16, 20, 1, 50, (16, 20), (1, 9), 0.5),
         (3, 8, 8, 1, 1, (6, 10), (0, 1), 1.0)]


@pytest.fixture(autouse=True)
def compiler():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH: the native pass is built from source")


def images_of(n_src, h, w, c, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n_src, h, w, c)).astype(np.uint8)


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_pass_equals_numpy_and_jax(case):
    n_src, h, w, c, n, out, padding, hflip = case
    images = images_of(n_src, h, w, c)
    idx = np.random.default_rng(1).integers(0, n_src, n)
    got = native.gather_crop_flip(images, idx, np.random.default_rng(7), out, padding, hflip)
    ref = augment.gather_crop_flip(images, idx, np.random.default_rng(7), out, padding, hflip)
    assert got.dtype == np.uint8 and got.shape == (n, *out, c)
    np.testing.assert_array_equal(got, ref)
    if not jnative.available():
        pytest.skip("the committed native/libcausal_gen_native.so does not load here")
    jax_out = jnative.gather_crop_flip(images, idx, np.random.default_rng(7), out, padding,
                                       hflip)
    np.testing.assert_array_equal(got, jax_out)


def test_pass_draws_as_the_plain_version():
    """The generator ends in the same state: later draws stay in step."""
    images = images_of(10, 12, 12, 1)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    native.gather_crop_flip(images, np.arange(10), r1, (12, 12), (2, 2), 0.5)
    augment.gather_crop_flip(images, np.arange(10), r2, (12, 12), (2, 2), 0.5)
    assert r1.integers(0, 2**62) == r2.integers(0, 2**62)


@pytest.mark.parametrize("n", [0, 1, 33])
def test_gather_equals_indexing_and_jax(n):
    images = images_of(40, 9, 7, 3)
    idx = np.random.default_rng(2).integers(0, 40, n)
    got = native.gather(images, idx)
    np.testing.assert_array_equal(got, images[idx])
    if not jnative.available():
        pytest.skip("the committed native/libcausal_gen_native.so does not load here")
    np.testing.assert_array_equal(got, jnative.gather(images, idx))


def test_bad_inputs_raise():
    images = images_of(4, 8, 8, 1)
    with pytest.raises(IndexError):
        native.gather(images, np.array([0, 4]))
    with pytest.raises(IndexError):
        native.gather_crop_flip(images, np.array([-1]), np.random.default_rng(0), (8, 8))
    with pytest.raises(TypeError):
        native.gather(images.astype(np.int16), np.array([0]))


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    setup_compilation_cache(str(tmp_path))
    try:
        monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-fno-such-flag"])
        with pytest.raises(RuntimeError, match="native build failed") as e:
            native.build()
        assert "no-such-flag" in str(e.value)
        assert not list(tmp_path.rglob("*.so"))
    finally:
        setup_compilation_cache()


def test_processes_building_at_once_all_load(tmp_path):
    """Six processes build into one empty directory at once (as the test
    workers may): each renames a whole library into place and loads it."""
    code = ("import sys\n"
            "from causal_gen_tpu_torch.utils.cache import setup_compilation_cache\n"
            "setup_compilation_cache(sys.argv[1])\n"
            "from causal_gen_tpu_torch.data import native\n"
            "import numpy as np\n"
            "a = np.arange(24, dtype=np.uint8).reshape(2, 3, 4, 1)\n"
            "assert (native.gather(a, np.array([1, 0])) == a[::-1]).all()\n"
            "print(native.library_path())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    assert len(list(tmp_path.rglob("*.so"))) == 1 and not list(tmp_path.rglob("*.tmp"))


def test_threads_loading_at_once_share_one_library(tmp_path, monkeypatch):
    """More threads than cores load the pass at once from an empty build
    directory (a prefetch thread and its caller may): one build, one
    library, every thread's batch right."""
    import threading
    import time

    setup_compilation_cache(str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    images = images_of(8, 6, 6, 1)
    results, errors = [], []

    def work():
        try:
            results.append((native.load(), native.gather(images, np.arange(8)[::-1])))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(2 * (os.cpu_count() or 4))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
        setup_compilation_cache()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(results) == len(threads) and time.perf_counter() - t0 < 300
    assert len({id(lib) for lib, _ in results}) == 1
    assert all(np.array_equal(x, images[::-1]) for _, x in results)
    assert len(list(tmp_path.rglob("*.so"))) == 1


def test_the_committed_binary_is_never_loaded():
    """A fresh process that runs the pass maps the library it built, not
    native/libcausal_gen_native.so."""
    code = ("import numpy as np\n"
            "from causal_gen_tpu_torch.data import native\n"
            "native.gather_crop_flip(np.zeros((2, 4, 4, 1), np.uint8), np.array([0, 1]),\n"
            "                        np.random.default_rng(0), (4, 4), (1, 1), 0.5)\n"
            "print(open('/proc/self/maps').read())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert str(native.library_path()) in out.stdout
    assert str(ROOT / "native" / "libcausal_gen_native.so") not in out.stdout


@pytest.fixture(scope="module")
def ukbb_tree(tmp_path_factory):
    from tools.e2e_synth import make_ukbb_tree

    root = str(tmp_path_factory.mktemp("ukbb"))
    make_ukbb_tree(root, n_per_split=6, seed=0)
    return root


def test_array_dataset_batches_equal_jax_on_ukbb(ukbb_tree):
    """The ukbb192 train split's batches (random_crop_flip with pad (p, 2p)
    and hflip 0.5) through the port's loader path and the JAX package's."""
    from causal_gen_tpu.data.datasets import setup_datasets as jsetup
    from causal_gen_tpu_torch.data.datasets import setup_datasets as tsetup

    ref = jsetup(jget("ukbb192", input_res=RES), ukbb_tree)["train"]
    got = tsetup(tget("ukbb192", input_res=RES), ukbb_tree)["train"]
    assert got.aug == ref.aug and got.aug[0] == "random_crop_flip" and got.aug[3] == 0.5
    for seed, idx in ((0, [0, 1, 2, 3]), (1, [5, 5, 0]), (2, [4, 2, 1, 3, 0, 5])):
        b_ref = ref.batch(np.asarray(idx), np.random.default_rng(seed))
        b_got = got.batch(np.asarray(idx), np.random.default_rng(seed))
        assert b_got["x"].dtype == np.uint8 and b_got["x"].shape == (len(idx), RES, RES, 1)
        np.testing.assert_array_equal(b_got["x"], b_ref["x"])
        np.testing.assert_array_equal(b_got["pa"], b_ref["pa"])


def test_noncontiguous_images_are_copied_once():
    from causal_gen_tpu_torch.data.datasets import ArrayDataset

    nchw = images_of(6, 3, 8, 8)  # (N, C, H, W) read as such
    ds = ArrayDataset(images=np.transpose(nchw, (0, 2, 3, 1)),
                      attrs={"a": np.zeros(6, np.float32)}, columns=("a",),
                      aug=("random_crop_flip", (8, 8), (1, 1), 0.5))
    assert ds.images.flags.c_contiguous
    b = ds.batch(np.arange(6), np.random.default_rng(0))
    ref = augment.gather_crop_flip(np.transpose(nchw, (0, 2, 3, 1)), np.arange(6),
                                   np.random.default_rng(0), (8, 8), (1, 1), 0.5)
    np.testing.assert_array_equal(b["x"], ref)
