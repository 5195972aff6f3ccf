"""Import hygiene of the port: ``causal_gen_tpu_torch``, ``chip_smoke.py`` and
the card's tests must start on a machine without JAX, and the K1 wrapper must not fall back to
its plain version when the build or the launch fails."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "causal_gen_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "causal_gen_tpu")


def _port_sources():
    files = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)
    return files + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_sample_kl_gpu.py"]


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


def test_sample_kl_has_no_fallback():
    tree = ast.parse((PKG / "ops" / "sample_kl.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert not handlers, "ops/sample_kl.py must not catch errors of the kernel's build or launch"


def test_no_binaries_and_small_files():
    for p in PKG.rglob("*"):
        if "_build" in p.relative_to(PKG).parts or not p.is_file():
            continue
        assert p.suffix not in (".so", ".o", ".pt", ".pth", ".npz"), p
        assert p.stat().st_size < 200_000, p
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "causal_gen_tpu_torch/_build/" in ignored
