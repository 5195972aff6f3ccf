"""Import hygiene of the port: ``causal_gen_tpu_torch``, ``chip_smoke.py`` and
the card's tests must start on a machine without JAX, and the kernel wrappers
(K1, K2, K3, K4) must not fall back to their plain versions when a build or a launch
fails."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "causal_gen_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "causal_gen_tpu")


def _port_sources():
    files = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)
    return files + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tests").glob("test_torch_*_gpu.py"))


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name", ["sample_kl", "dmol_loss", "dmol_sample", "fused_block",
                                  "build"])
def test_kernel_wrappers_have_no_fallback(name):
    tree = ast.parse((PKG / "ops" / f"{name}.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)
                and not (isinstance(n.type, ast.Attribute) and n.type.attr == "TimeoutExpired")]
    assert not handlers, f"ops/{name}.py must not catch errors of a kernel's build or launch"


def test_the_mimic_slice_modules_are_checked():
    """The modules the mimic192 slice and the checkpoint converter add to or
    change are among those held to the rules above."""
    checked = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for rel in ("convert.py", "pgm/base.py", "pgm/modules.py", "pgm/flow_pgm.py", "pgm/dscm.py",
                "data/datasets.py"):
        assert f"causal_gen_tpu_torch/{rel}" in checked, rel
    assert "chip_smoke.py" in checked


@pytest.mark.parametrize("rel", ["models/blocks.py", "models/hvae.py", "models/likelihoods.py",
                                 "ops/sample_kl.py", "pgm/dscm.py", "convert.py",
                                 "train/vae_trainer.py", "data/datasets.py", "cli/main.py"])
def test_the_variant_slice_modules_are_checked(rel):
    """Each module the cond_prior, q_correction and 3-D slice adds to or
    changes is among those held to the rules above."""
    assert f"causal_gen_tpu_torch/{rel}" in {str(p.relative_to(ROOT)) for p in _port_sources()}


def test_every_module_imports_without_jax():
    """Import every module of the package in a fresh interpreter that refuses
    JAX and the JAX package."""
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                     for p in PKG.rglob("*.py") if "_build" not in p.parts)
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import importlib, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert len(modules) >= 25


def test_no_binaries_and_small_files():
    for p in PKG.rglob("*"):
        if "_build" in p.relative_to(PKG).parts or not p.is_file():
            continue
        assert p.suffix not in (".so", ".o", ".pt", ".pth", ".npz"), p
        assert p.stat().st_size < 200_000, p
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "causal_gen_tpu_torch/_build/" in ignored
