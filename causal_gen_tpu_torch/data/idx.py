"""Minimal IDX (MNIST-format) array reader: a copy of
``causal_gen_tpu/data/idx.py`` (reference src/datasets.py:138-163), written
against the public IDX spec (magic: 2 zero bytes, dtype code, ndim, then
big-endian uint32 dims, then row-major payload).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_IDX_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def load_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zeros, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zeros != 0 or dtype_code not in _IDX_DTYPES:
            raise ValueError(f"not an IDX file: {path}")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = np.dtype(_IDX_DTYPES[dtype_code])
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
        return data.reshape(shape).astype(dtype.newbyteorder("="))
