"""Builds the port's CUDA kernels with plain ``nvcc`` and loads them with ctypes.

Each source under ``csrc/`` has a plain C interface and includes no PyTorch
header, so one ``nvcc`` call builds it in seconds. The shared library goes into
``causal_gen_tpu_torch/_build/<fingerprint>/<hash>/``: the fingerprint names
the host (``utils/cache.py``), the hash covers the source and the flags, so a
later run on the same host finds it there and skips the build. ``_build/`` is
listed in ``.gitignore``. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

from causal_gen_tpu_torch.utils.cache import build_dir

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCES: Dict[str, Path] = {name: PACKAGE_DIR / "csrc" / f"{name}.cu"
                            for name in ("sample_kl", "dmol_loss", "dmol_sample", "fused_block")}
# -fmad=false: no multiply-add is contracted, so a kernel rounds one operation
# at a time as its plain PyTorch version does
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
BUILD_TIMEOUT_S = 300

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH, in CUDA_HOME or in /usr/local/cuda/bin")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built, keyed by source and flags."""
    src = SOURCES[name]
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return Path(build_dir()) / key / f"lib{name}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Build the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together. Raises with the
    compiler's output when a build fails or times out."""
    names = list(SOURCES) if names is None else names
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failed.append(f"{name}: nvcc timed out after {BUILD_TIMEOUT_S} s\n{log}")
            continue
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    if name not in _LOADED:
        path = build_all([name])[name]
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
