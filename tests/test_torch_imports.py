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


def _twins():
    """The port's twins of the JAX package's tools and examples."""
    return sorted((ROOT / "tools").glob("*_torch.py")) + sorted(
        (ROOT / "examples").glob("*_torch.py"))


def _port_sources():
    files = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)
    return (files + [ROOT / "chip_smoke.py"] + _twins()
            + sorted((ROOT / "tests").glob("test_torch_*_gpu.py")))


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


@pytest.mark.parametrize("rel", ["models/simple_vae.py", "models/likelihoods.py",
                                 "ops/distributions.py", "pgm/base.py", "pgm/transforms.py",
                                 "pgm/flow_pgm.py", "pgm/dscm.py", "pgm/train_pgm.py",
                                 "cli/train_pgm.py", "cli/main.py", "utils/metrics.py",
                                 "data/loader.py", "convert.py"])
def test_the_pgm_training_slice_modules_are_checked(rel):
    """Each module the PGM-training, counterfactual-engine and simple-VAE
    slice adds or changes is among those held to the rules above, and so is
    its card test."""
    checked = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert f"causal_gen_tpu_torch/{rel}" in checked
    assert "tests/test_torch_pgm_train_gpu.py" in checked


@pytest.mark.parametrize("rel", ["ops/soft_morph.py", "eval/__init__.py", "eval/morphometrics.py",
                                 "eval/cf_eval.py", "pgm/train_cf.py", "pgm/dscm.py",
                                 "pgm/flow_pgm.py", "cli/train_cf.py", "cli/evaluate.py",
                                 "convert.py", "train/checkpoint.py"])
def test_the_cf_training_slice_modules_are_checked(rel):
    """Each module the counterfactual fine-tuning and evaluation slice adds
    or changes is among those held to the rules above, and so is its card
    test; the new modules import in the JAX-free interpreter below."""
    checked = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert f"causal_gen_tpu_torch/{rel}" in checked
    assert "tests/test_torch_cf_gpu.py" in checked


@pytest.mark.parametrize("rel", ["causal_gen_tpu_torch/models/remat.py",
                                 "causal_gen_tpu_torch/models/blocks.py",
                                 "causal_gen_tpu_torch/models/hvae.py",
                                 "causal_gen_tpu_torch/utils/viz.py",
                                 "causal_gen_tpu_torch/utils/plots.py",
                                 "causal_gen_tpu_torch/cli/main.py",
                                 "causal_gen_tpu_torch/cli/train_pgm.py",
                                 "causal_gen_tpu_torch/cli/train_cf.py",
                                 "causal_gen_tpu_torch/cli/evaluate.py",
                                 "causal_gen_tpu_torch/data/datasets.py",
                                 "causal_gen_tpu_torch/pgm/dscm.py",
                                 "tools/e2e_synth_torch.py",
                                 "examples/counterfactual_demo_torch.py",
                                 "examples/vol3d_demo_torch.py",
                                 "tests/test_torch_remat_gpu.py"])
def test_the_flagship_training_slice_modules_are_checked(rel):
    """Each module the remat, viz, end-to-end and demo slice adds or changes,
    its twins of the JAX tools and examples and its card test are among
    those held to the rules above; the twins import in the JAX-free
    interpreter below."""
    assert rel in {str(p.relative_to(ROOT)) for p in _port_sources()}


@pytest.mark.parametrize("rel", ["causal_gen_tpu_torch/parallel/__init__.py",
                                 "causal_gen_tpu_torch/parallel/distributed.py",
                                 "causal_gen_tpu_torch/parallel/mesh.py",
                                 "causal_gen_tpu_torch/parallel/collectives.py",
                                 "causal_gen_tpu_torch/parallel/tensor.py",
                                 "causal_gen_tpu_torch/parallel/spatial.py",
                                 "causal_gen_tpu_torch/parallel/launch.py",
                                 "causal_gen_tpu_torch/parallel/dryrun.py",
                                 "causal_gen_tpu_torch/train/vae_trainer.py",
                                 "causal_gen_tpu_torch/train/state.py",
                                 "causal_gen_tpu_torch/train/checkpoint.py",
                                 "causal_gen_tpu_torch/pgm/train_pgm.py",
                                 "causal_gen_tpu_torch/pgm/train_cf.py",
                                 "causal_gen_tpu_torch/models/simple_vae.py",
                                 "examples/multihost_train_torch.py",
                                 "tests/test_torch_parallel_gpu.py"])
def test_the_parallel_slice_modules_are_checked(rel):
    """Each module the parallelism slice adds or changes, its twin of the
    multi-host example and its card test are among those held to the rules
    above; the twin imports in the JAX-free interpreter below."""
    assert rel in {str(p.relative_to(ROOT)) for p in _port_sources()}


@pytest.mark.parametrize("rel", ["causal_gen_tpu_torch/utils/cache.py",
                                 "causal_gen_tpu_torch/data/native.py",
                                 "causal_gen_tpu_torch/ops/s2d.py",
                                 "causal_gen_tpu_torch/utils/profiling.py",
                                 "causal_gen_tpu_torch/ops/build.py",
                                 "causal_gen_tpu_torch/data/datasets.py",
                                 "causal_gen_tpu_torch/cli/main.py",
                                 "causal_gen_tpu_torch/cli/train_pgm.py",
                                 "causal_gen_tpu_torch/cli/train_cf.py",
                                 "causal_gen_tpu_torch/cli/evaluate.py",
                                 "tools/trace_ops_torch.py",
                                 "tools/device_time_torch.py",
                                 "tools/mfu_torch.py",
                                 "tools/export_eval_ckpt_torch.py",
                                 "tools/make_cmnist_torch.py"])
def test_the_tail_slice_modules_are_checked(rel):
    """Each module the tail slice adds or changes (the last four counterparts
    of the JAX package's modules) and its twins of the JAX profiling and
    data tools are among those held to the rules above; the twins import in
    the JAX-free interpreter below."""
    assert rel in {str(p.relative_to(ROOT)) for p in _port_sources()}


def test_the_native_pass_has_no_fallback():
    """data/native.py raises when its build fails: no handler but the
    compiler's time limit, and no path to the committed binary."""
    src = (PKG / "data" / "native.py").read_text()
    handlers = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.ExceptHandler)
                and not (isinstance(n.type, ast.Attribute) and n.type.attr == "TimeoutExpired")]
    assert not handlers
    assert '"native" / "augment.cpp"' in src and '"native" / "libcausal_gen_native.so"' not in src


def test_the_rank_helpers_import_no_jax():
    """tests/torch_dist.py is what each spawned rank of the parallel tests
    imports: a plain PyTorch process."""
    path = ROOT / "tests" / "torch_dist.py"
    bad = [m for m in _imported_modules(ast.parse(path.read_text()))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_every_module_imports_without_jax():
    """Import every module of the package in a fresh interpreter that refuses
    JAX and the JAX package."""
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                     for p in PKG.rglob("*.py") if "_build" not in p.parts)
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import importlib, importlib.util, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"for p in {[str(p) for p in _twins()]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('twin', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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
