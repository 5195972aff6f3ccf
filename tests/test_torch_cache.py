"""Per-host build directory of the port (causal_gen_tpu_torch/utils/cache.py),
the counterpart of tests/test_cache.py: the fingerprint is stable, the build
directory is a fingerprint subdirectory of its base, and both the nvcc
kernels (ops/build.py) and the native augment pass (data/native.py) build
under it. Each of the port's CLIs sets it up first, as its JAX twin does."""

import ast
import os
import pathlib
import re

import pytest
import torch

from causal_gen_tpu.utils.cache import host_fingerprint as jax_host_fingerprint
from causal_gen_tpu_torch.data import native
from causal_gen_tpu_torch.ops import build
from causal_gen_tpu_torch.utils import cache
from causal_gen_tpu_torch.utils.cache import build_dir, host_fingerprint, setup_compilation_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "causal_gen_tpu_torch"


@pytest.fixture
def restore_default():
    yield
    setup_compilation_cache()


def test_fingerprint_stable_and_hexish():
    a, b = host_fingerprint(), host_fingerprint()
    assert a == b
    assert re.fullmatch(r"[0-9a-f]{12}", a)
    # keyed by torch's version where JAX's is keyed by jax's: not the same id
    assert a != jax_host_fingerprint()


def test_fingerprint_follows_the_torch_and_cuda_versions(monkeypatch):
    a = host_fingerprint()
    monkeypatch.setattr(torch, "__version__", torch.__version__ + "+other")
    b = host_fingerprint()
    monkeypatch.setattr(torch.version, "cuda", "0.0")
    assert len({a, b, host_fingerprint()}) == 3


def test_build_dir_is_host_scoped(tmp_path, restore_default):
    d = setup_compilation_cache(str(tmp_path))
    # the directory is a fingerprint SUBDIR of the base, never the base itself
    assert os.path.dirname(d) == str(tmp_path)
    assert os.path.basename(d) == host_fingerprint()
    assert build_dir() == d


def test_default_base_is_the_ignored_build_dir(restore_default):
    d = pathlib.Path(setup_compilation_cache())
    assert d.parent == PKG / "_build"
    assert d.name == host_fingerprint()
    assert "causal_gen_tpu_torch/_build/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("base", ["default", "custom"])
def test_kernels_and_native_pass_build_under_it(base, tmp_path, restore_default):
    d = pathlib.Path(setup_compilation_cache(None if base == "default" else str(tmp_path)))
    for name in build.SOURCES:
        p = build.library_path(name)
        # <fingerprint dir>/<source-and-flags hash>/lib<name>.so
        assert p.parent.parent == d and p.name == f"lib{name}.so"
        assert re.fullmatch(r"[0-9a-f]{16}", p.parent.name)
    p = native.library_path()
    assert p.parent.parent == d and p.name == "libcausal_gen_native.so"
    assert p != ROOT / "native" / "libcausal_gen_native.so"


def test_build_dir_defaults_without_setup(monkeypatch):
    monkeypatch.setattr(cache, "_dir", None)
    assert pathlib.Path(build_dir()) == PKG / "_build" / host_fingerprint()


@pytest.mark.parametrize("cli", ["main", "train_pgm", "train_cf", "evaluate"])
def test_each_cli_sets_up_the_build_dir_first(cli):
    """The first statement of each CLI's main() (after its docstring) is
    setup_compilation_cache(), as in causal_gen_tpu/cli/<cli>.py."""
    tree = ast.parse((PKG / "cli" / f"{cli}.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = [s for s in main.body
            if not (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))]
    first = body[0]
    assert isinstance(first, ast.Expr) and isinstance(first.value, ast.Call)
    assert getattr(first.value.func, "id", None) == "setup_compilation_cache"
