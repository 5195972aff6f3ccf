"""K4: the discretized mixture-of-logistics sampler.

Port of ``dmol_sample_pallas`` (causal_gen_tpu/ops/pallas_kernels.py:342,
kernel ``_dmol_sample_kernel`` at :288): a CUDA C++ kernel for sm_90a in
``csrc/dmol_sample.cu``, built by ``ops/build.py`` and bound with ctypes.

``dmol_sample`` launches the kernel for CUDA tensors and runs the plain
version, ``ops/dmol.py::sample_from_discretized_mix_logistic``, for CPU
tensors; nothing gives way to the plain version on the card. Tensors are NCHW:
l (B, 10K, H, W) in, x and scale (B, 3, H, W) out.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from causal_gen_tpu_torch.ops import build
from causal_gen_tpu_torch.ops.dmol import sample_from_discretized_mix_logistic


@functools.cache
def _bind():
    """The kernel's C entry point, built and loaded on first use."""
    fn = build.load("dmol_sample").dmol_sample_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_uint64, ctypes.c_uint64,
                                           ctypes.c_void_p]
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
    x = torch.empty((b, 3, h, w), device=l.device, dtype=torch.float32)
    scale = torch.empty_like(x)
    err = _bind()(l.data_ptr(), None if u_mix is None else u_mix.data_ptr(),
                  None if u is None else u.data_ptr(), x.data_ptr(), scale.data_ptr(),
                  b * h * w, h * w, nr_mix, math.log(t), seed, offset,
                  torch.cuda.current_stream(l.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dmol_sample_forward launch failed: cudaError {err}")
    dmol_sample.launches += 1
    return x, scale


dmol_sample.launches = 0  # kernel launches since the caller last set it to 0
