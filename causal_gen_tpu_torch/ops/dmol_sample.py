"""K4: the discretized mixture-of-logistics sampler.

Port of ``dmol_sample_pallas`` (causal_gen_tpu/ops/pallas_kernels.py:342,
kernel ``_dmol_sample_kernel`` at :288): a CUDA C++ kernel for sm_90a in
``csrc/dmol_sample.cu``, built by ``ops/build.py`` and bound with ctypes.

``plan`` fixes the launch: a block takes 32 consecutive flat pixels, a warp
a mixture for the draws and perturbed logits, then a warp a colour channel
for the rest (see the source's note). ``dmol_sample`` launches the kernel for CUDA tensors and runs the plain
version, ``ops/dmol.py::sample_from_discretized_mix_logistic``, for CPU
tensors; nothing gives way to the plain version on the card. Tensors are NCHW:
l (B, 10K, H, W) in, x and scale (B, 3, H, W) out.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from causal_gen_tpu_torch.ops import build
from causal_gen_tpu_torch.ops.dmol import sample_from_discretized_mix_logistic


TILE = 32  # flat pixels a block, one a lane, as compiled into csrc/dmol_sample.cu (kTile)
MAX_WARPS = 32  # warps a block at most (kMaxWarps): one a mixture, at least 3


class Plan(NamedTuple):
    """A launch of K4's kernel."""
    tile: int  # consecutive flat pixels a block, one lane each
    threads: int  # 32 a warp: a warp a mixture (cycling past MAX_WARPS), at least 3
    blocks: int  # one a tile, the last one ragged
    shared_bytes: int  # [K][tile] perturbed logits, [3][tile] v, y and tanh(coeff) each
    straddles: bool  # some tile holds pixels of two images


def plan(n_pix: int, hw: int, nr_mix: int = 10) -> Plan:
    """The launch of K4 on n_pix = B*H*W pixels of images of hw = H*W pixels
    with nr_mix mixtures: tiles of TILE consecutive flat pixels, one block a
    tile, one warp a mixture for the draws and perturbed logits (warp w takes
    mixtures w, w + warps, ..., then the 3 channels' draws) and warps 0-2 a
    colour channel each afterwards."""
    if n_pix < 0 or hw < 0 or (n_pix and (hw == 0 or n_pix % hw)):
        raise ValueError(f"dmol_sample: {n_pix} pixels are not whole images of {hw}")
    if nr_mix <= 0:
        raise ValueError(f"dmol_sample: {nr_mix} mixtures")
    warps = min(max(nr_mix, 3), MAX_WARPS)
    blocks = -(-n_pix // TILE)
    if blocks >= 2 ** 31:
        raise ValueError(f"dmol_sample: {n_pix} pixels need more than 2^31 - 1 blocks")
    return Plan(TILE, 32 * warps, blocks, 4 * TILE * (nr_mix + 9),
                n_pix > hw and hw % TILE != 0)


@functools.cache
def _bind():
    """The kernel's C entry point, built and loaded on first use."""
    fn = build.load("dmol_sample").dmol_sample_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_uint64, ctypes.c_uint64,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: Tensor, shape, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"dmol_sample: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; expected "
            f"contiguous float32 {tuple(shape)} on {device}")


def dmol_sample(
    l: Tensor,
    nr_mix: int,
    t: float = 1.0,
    u_mix: Optional[Tensor] = None,
    u: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Tensor]:
    """(x, scale) sampled from NCHW l (B, 10K, H, W) at temperature ``t``.

    ``u_mix`` (B, K, H, W) and ``u`` (B, 3, H, W) are the uniforms in
    [1e-5, 1 - 1e-5) (the parity mode), given together or not at all. Without
    them, a CUDA call draws them in the kernel from Philox, seeded by two
    integers taken from ``generator`` (a CPU ``torch.Generator``; the default
    generator if None), and a CPU call draws them from the same generator.
    CUDA inputs must be contiguous float32 on one device.
    """
    if (u_mix is None) != (u is None):
        raise ValueError("dmol_sample: give u_mix and u together or not at all")
    if l.device.type == "cpu":
        return sample_from_discretized_mix_logistic(l, nr_mix, t, u_mix, u, generator)
    if l.device.type != "cuda":
        raise ValueError(f"dmol_sample: no kernel for device {l.device}")
    if l.dim() != 4 or l.shape[1] != 10 * nr_mix:
        raise ValueError(f"dmol_sample: l {tuple(l.shape)} is not (B, {10 * nr_mix}, H, W)")
    b, _, h, w = l.shape
    _check("l", l, l.shape, l.device)
    if u_mix is not None:
        _check("u_mix", u_mix, (b, nr_mix, h, w), l.device)
        _check("u", u, (b, 3, h, w), l.device)
    if not t > 0:
        raise ValueError(f"dmol_sample: temperature {t} is not > 0")
    seed, offset = 0, 0
    if u_mix is None:
        seed, offset = (int(v) for v in torch.randint(
            0, 2**62, (2,), generator=generator, dtype=torch.int64))
    p = plan(b * h * w, h * w, nr_mix)
    x = torch.empty((b, 3, h, w), device=l.device, dtype=torch.float32)
    scale = torch.empty_like(x)
    err = _bind()(l.data_ptr(), None if u_mix is None else u_mix.data_ptr(),
                  None if u is None else u.data_ptr(), x.data_ptr(), scale.data_ptr(),
                  b * h * w, h * w, nr_mix, math.log(t), seed, offset, p.threads,
                  p.shared_bytes, torch.cuda.current_stream(l.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dmol_sample_forward launch failed: cudaError {err}")
    dmol_sample.launches += 1
    return x, scale


dmol_sample.launches = 0  # kernel launches since the caller last set it to 0
