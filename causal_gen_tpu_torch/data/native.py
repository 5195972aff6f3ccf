"""The host-side augment pass (``native/augment.cpp``), built from source and
bound with ctypes.

Counterpart of ``causal_gen_tpu/data/native.py``. One multithreaded C++ pass
fuses the batch gather, zero pad, random crop and horizontal flip of uint8
NHWC images. The JAX package loads a committed ``native/libcausal_gen_native.so``
and falls back to numpy when it does not load; the port never loads that
binary. It compiles ``native/augment.cpp`` at first use with the Makefile's
flags (``-march=native``) into this host's build directory
(``utils/cache.py``: ``_build/<fingerprint>/<hash>/``), as ``ops/build.py``
builds the kernels: a temporary file renamed into place, so that processes
building at once each end with a whole library. A failed build raises with
the compiler's output; nothing falls back. The draws are JAX's, in its
order, so a seed gives its batches; ``data/augment.py::gather_crop_flip`` is
the pass's plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from causal_gen_tpu_torch.utils.cache import build_dir

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "augment.cpp"
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LD_FLAGS = ["-lpthread"]
BUILD_TIMEOUT_S = 120

_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()  # a prefetch thread and the caller may load at once
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def compiler() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH to build native/augment.cpp")
    return found


def library_path() -> Path:
    """Where this host builds the pass, keyed by source and flags."""
    if not SOURCE.is_file():
        raise RuntimeError(f"{SOURCE} not found: the augment pass is built from the "
                           "repository's native/ sources")
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LD_FLAGS).encode()
                         ).hexdigest()[:16]
    return Path(build_dir()) / key / "libcausal_gen_native.so"


def build() -> Path:
    """Build the library unless this host has it; raises with the compiler's
    output when the build fails or times out."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"native build timed out after {BUILD_TIMEOUT_S} s: "
                           f"{' '.join(cmd)}\n{e.output}") from None
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    global _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
    return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the pass's C signatures (native/augment.cpp)."""
    lib.cg_gather_crop_flip.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _I64P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _I32P, _I32P, _U8P, _U8P,
    ]
    lib.cg_gather_crop_flip.restype = None
    lib.cg_gather.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64, _I64P, ctypes.c_int64, _U8P]
    lib.cg_gather.restype = None
    return lib


def _checked(images: np.ndarray, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 C-contiguous images and int64 indices inside them: the pass
    reads through raw pointers and checks nothing."""
    if images.dtype != np.uint8:
        raise TypeError(f"the augment pass takes uint8 images, got {images.dtype}")
    idx64 = np.ascontiguousarray(idx, np.int64)
    if idx64.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {idx64.shape}")
    if len(idx64) and (idx64.min() < 0 or idx64.max() >= images.shape[0]):
        raise IndexError(f"idx out of [0, {images.shape[0]})")
    return np.ascontiguousarray(images), idx64


def gather_crop_flip(
    images: np.ndarray,  # (N_src, H, W, C) uint8
    idx: np.ndarray,  # (n,) int
    rng: np.random.Generator,
    out_size: Tuple[int, int],
    padding: Tuple[int, int] = (0, 0),
    hflip_p: float = 0.0,
) -> np.ndarray:
    """images[idx], zero-padded by ``padding``, cropped at a random origin to
    ``out_size`` and flipped left-right with probability ``hflip_p``, in one
    pass. Draws the crop rows, then the columns, then (only if hflip_p > 0)
    the flips, one per image, as the JAX package's pass does."""
    if images.ndim != 4:
        raise ValueError(f"images must be (N, H, W, C), got shape {images.shape}")
    images, idx64 = _checked(images, idx)
    lib = load()
    n = len(idx64)
    n_src, h, w, c = images.shape
    out_h, out_w = out_size
    ph, pw = padding
    ys = rng.integers(0, h + 2 * ph - out_h + 1, size=n).astype(np.int32)
    xs = rng.integers(0, w + 2 * pw - out_w + 1, size=n).astype(np.int32)
    flips = ((rng.random(n) < hflip_p).astype(np.uint8) if hflip_p > 0
             else np.zeros(n, np.uint8))
    out = np.empty((n, out_h, out_w, c), np.uint8)
    lib.cg_gather_crop_flip(
        images.ctypes.data_as(_U8P), n_src, h, w, c,
        idx64.ctypes.data_as(_I64P), n, ph, pw, out_h, out_w,
        ys.ctypes.data_as(_I32P), xs.ctypes.data_as(_I32P), flips.ctypes.data_as(_U8P),
        out.ctypes.data_as(_U8P),
    )
    return out


def gather(images: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """images[idx] in one pass."""
    images, idx64 = _checked(images, idx)
    lib = load()
    n = len(idx64)
    out = np.empty((n, *images.shape[1:]), np.uint8)
    lib.cg_gather(images.ctypes.data_as(_U8P), images.shape[0], int(np.prod(images.shape[1:])),
                  idx64.ctypes.data_as(_I64P), n, out.ctypes.data_as(_U8P))
    return out
