"""Per-host build directory of the port's native libraries.

Counterpart of ``causal_gen_tpu/utils/cache.py``. The JAX package keys its
XLA compile cache by a host fingerprint because a cache shared across hosts
was poisoned: entries compiled for one CPU broke another. The port compiles
nothing with inductor; what it compiles are its ``nvcc`` kernels
(``ops/build.py``) and the host-side augment pass, built with
``-march=native`` (``data/native.py``). Both go under
``<base>/<fingerprint>/``, so a checkout shared by two machines starts each
with an empty directory of its own instead of one built for another CPU.
The base is ``causal_gen_tpu_torch/_build`` (git-ignored) unless
``setup_compilation_cache`` is given another. Each CLI calls it first, where
its JAX twin sets up its cache.
"""

from __future__ import annotations

import hashlib
import os
import platform
from typing import Optional

import torch

_BASE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_dir: Optional[str] = None  # set by setup_compilation_cache


def host_fingerprint() -> str:
    """Stable id of this machine's build target: the CPU's architecture and
    feature flags, and the torch and CUDA versions."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        flags = ""
    ident = f"{platform.machine()}|{flags.strip()}|{torch.__version__}|{torch.version.cuda}"
    return hashlib.sha1(ident.encode()).hexdigest()[:12]


def setup_compilation_cache(path: Optional[str] = None) -> str:
    """Build under ``<path or the default base>/<fingerprint>`` from now on;
    returns that directory."""
    global _dir
    _dir = os.path.join(path or _BASE_DIR, host_fingerprint())
    return _dir


def build_dir() -> str:
    """The directory this host's libraries are built in."""
    return _dir or setup_compilation_cache()
