"""K2: the body of the "light" residual block in one pass.

Port of ``fused_light_block`` (causal_gen_tpu/ops/fused_block.py:190, kernel
``_fused_light_block_kernel`` at :51): a CUDA C++ kernel for sm_90a in
``csrc/fused_block.cu``, built by ``ops/build.py`` and bound with ctypes.

    y = x + conv3x3(relu(conv3x3(relu(x), w1) + b1), w2) + b2

with "SAME" zero padding, float32 accumulation, mid rounded once to x's
dtype and y = x + acc rounded once (the JAX kernel's ``mid_ring`` and
``acc + res.astype(f32)``). It differs from the JAX kernel in three ways: the
biases are optional (with none it is the JAX function), tensors are NCHW with
OIHW weights instead of the TPU's (H, C, W*B) ring layout, and the storage
type is float32 or bf16. Like the JAX kernel it has no gradient.

``fused_light_block`` launches the kernel for CUDA tensors and runs the plain
version, ``fused_light_block_ref``, for CPU tensors; nothing gives way to the
plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from causal_gen_tpu_torch.ops import build

SMEM_LIMIT = 232_448  # bytes of shared memory one block can have on the H100 (227 KB)
SMEM_TARGET = 100 * 1024  # the tile is cut down to this where it can be: 2 blocks an SM
MAX_TILE = 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_light_block_ref(x: Tensor, w1: Tensor, w2: Tensor, b1: Optional[Tensor] = None,
                          b2: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch version of the kernel: both convs in float32 on values of
    x's dtype, mid and y each rounded once to x's dtype."""
    dt = x.dtype
    b1, b2 = (None if b is None else b.float() for b in (b1, b2))
    mid = F.conv2d(F.relu(x).float(), w1.float(), b1, padding=1).to(dt)
    out = F.conv2d(F.relu(mid).float(), w2.float(), b2, padding=1)
    return (x.float() + out).to(dt)


def smem_bytes(c: int, cb: int, th: int, tw: int) -> int:
    """Shared memory of one block: relu(x) with a 2-pixel halo and relu(mid)
    with a 1-pixel halo, as float32."""
    return 4 * (c * (th + 4) * (tw + 4) + cb * (th + 2) * (tw + 2))


def tile_for(c: int, cb: int, h: int, w: int) -> Tuple[int, int, int]:
    """(TH, TW, shared bytes) of a launch: up to 16 x 16, halved along the
    longer side until the shared memory is under SMEM_TARGET or the tile is
    one pixel."""
    th, tw = min(h, MAX_TILE), min(w, MAX_TILE)
    while smem_bytes(c, cb, th, tw) > SMEM_TARGET and th * tw > 1:
        if th >= tw:
            th = (th + 1) // 2
        else:
            tw = (tw + 1) // 2
    return th, tw, smem_bytes(c, cb, th, tw)


@functools.cache
def _bind():
    """The kernel's C entry point, built and loaded on first use."""
    fn = build.load("fused_block").fused_light_block_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: Tensor, shape, like: Tensor) -> None:
    if t.device != like.device or t.dtype != like.dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"fused_light_block: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; expected "
            f"contiguous {like.dtype} {tuple(shape)} on {like.device}")


def fused_light_block(x: Tensor, w1: Tensor, w2: Tensor, b1: Optional[Tensor] = None,
                      b2: Optional[Tensor] = None) -> Tensor:
    """y = x + conv3x3(relu(conv3x3(relu(x), w1) + b1), w2) + b2 on NCHW x
    (B, C, H, W) with OIHW w1 (b, C, 3, 3) and w2 (C, b, 3, 3).

    CUDA inputs must be contiguous, all float32 or all bf16, on one device;
    the biases (b,) and (C,) may be None. A CPU call runs
    ``fused_light_block_ref``."""
    if x.device.type == "cpu":
        return fused_light_block_ref(x, w1, w2, b1, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_light_block: no kernel for device {x.device}")
    if x.dtype not in DTYPES or x.dim() != 4:
        raise ValueError(f"fused_light_block: x is {x.dtype} {tuple(x.shape)}; expected a "
                         f"float32 or bf16 (B, C, H, W) tensor")
    b, c, h, w = x.shape
    cb = w1.shape[0]
    _check("x", x, x.shape, x)
    _check("w1", w1, (cb, c, 3, 3), x)
    _check("w2", w2, (c, cb, 3, 3), x)
    if b1 is not None:
        _check("b1", b1, (cb,), x)
    if b2 is not None:
        _check("b2", b2, (c,), x)
    th, tw, smem = tile_for(c, cb, h, w)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_light_block: C={c}, b={cb} needs {smem} B of shared memory "
                         f"even at a 1x1 tile; the card has {SMEM_LIMIT}")
    if b > 65535:
        raise ValueError(f"fused_light_block: batch {b} exceeds the grid's 65535")
    y = torch.empty_like(x)
    err = _bind()(x.data_ptr(), w1.data_ptr(), None if b1 is None else b1.data_ptr(),
                  w2.data_ptr(), None if b2 is None else b2.data_ptr(), y.data_ptr(),
                  DTYPES[x.dtype], b, c, cb, h, w, th, tw, smem,
                  torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_light_block_forward launch failed: cudaError {err}")
    fused_light_block.launches += 1
    return y


fused_light_block.launches = 0  # kernel launches since the caller last set it to 0
