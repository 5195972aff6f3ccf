"""K1: fused reparameterised Gaussian sample + per-element Gaussian KL.

Port of ``fused_sample_kl`` (causal_gen_tpu/ops/pallas_kernels.py:109, kernel
``_sample_kl_kernel`` at :54). The kernel is CUDA C++ for sm_90a in
``csrc/sample_kl.cu``, built by ``ops/build.py`` and bound with ctypes.

``fused_sample_kl`` launches the kernel for CUDA tensors and runs the plain
version, ``fused_sample_kl_ref``, for CPU tensors; nothing gives way to the
plain version on the card. The forward is all that serving needs: the
backward (``_fskl_bwd``, pallas_kernels.py:136-147) comes with the training
slice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch import Tensor

from causal_gen_tpu_torch.ops import build


def fused_sample_kl_ref(
    q_loc: Tensor, q_logscale: Tensor, p_loc: Tensor, p_logscale: Tensor, eps: Tensor
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel, same operations in the same order:
    (z, kl) with z = q_loc + exp(q_logscale) * eps and kl = KL(q || p)."""
    q_scale = torch.exp(q_logscale)
    z = q_loc + q_scale * eps
    kl = (
        -0.5
        + p_logscale
        - q_logscale
        + 0.5 * (q_scale**2 + (q_loc - p_loc) ** 2) / torch.exp(p_logscale) ** 2
    )
    return z, kl


@functools.cache
def _bind():
    """The kernel's C entry point, built and loaded on first use."""
    lib = build.load("sample_kl")
    fn = lib.sample_kl_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_uint64,
                                           ctypes.c_uint64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: Tensor, like: Tensor) -> None:
    if t.device != like.device or t.dtype != torch.float32 or t.shape != like.shape:
        raise ValueError(
            f"fused_sample_kl: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
            f"expected float32 {tuple(like.shape)} on {like.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_sample_kl: {name} must be contiguous")


def _launch(q_loc, q_logscale, p_loc, p_logscale, eps, seed, offset):
    fn = _bind()
    z = torch.empty_like(q_loc)
    kl = torch.empty_like(q_loc)
    err = fn(q_loc.data_ptr(), q_logscale.data_ptr(), p_loc.data_ptr(),
             p_logscale.data_ptr(), None if eps is None else eps.data_ptr(),
             z.data_ptr(), kl.data_ptr(), q_loc.numel(), seed, offset,
             torch.cuda.current_stream(q_loc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sample_kl_forward launch failed: cudaError {err}")
    fused_sample_kl.launches += 1
    return z, kl


class _FusedSampleKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_loc, q_logscale, p_loc, p_logscale, eps, seed, offset):
        return _launch(q_loc, q_logscale, p_loc, p_logscale, eps, seed, offset)

    @staticmethod
    def backward(ctx, gz, gkl):
        raise NotImplementedError("K1 backward lands with the training slice")


def fused_sample_kl(
    q_loc: Tensor,
    q_logscale: Tensor,
    p_loc: Tensor,
    p_logscale: Tensor,
    eps: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Tensor]:
    """z ~ N(q_loc, exp(q_logscale)) and kl = KL(q || p), per element.

    ``eps`` is the standard-normal draw (the parity mode). Without it, a CUDA
    call draws eps in the kernel from Philox, seeded by two integers taken from
    ``generator`` (a CPU ``torch.Generator``; the default generator if None),
    and a CPU call draws it with ``torch.randn`` from the same generator.
    CUDA inputs must be contiguous float32 of one shape on one device.
    """
    if q_loc.device.type == "cpu":
        if eps is None:
            eps = torch.randn(q_loc.shape, generator=generator, dtype=q_loc.dtype)
        return fused_sample_kl_ref(q_loc, q_logscale, p_loc, p_logscale, eps)
    if q_loc.device.type != "cuda":
        raise ValueError(f"fused_sample_kl: no kernel for device {q_loc.device}")
    for name, t in (("q_loc", q_loc), ("q_logscale", q_logscale), ("p_loc", p_loc),
                    ("p_logscale", p_logscale)) + ((("eps", eps),) if eps is not None else ()):
        _check(name, t, q_loc)
    seed, offset = 0, 0
    if eps is None:
        seed, offset = (int(v) for v in torch.randint(
            0, 2**62, (2,), generator=generator, dtype=torch.int64))
    return _FusedSampleKL.apply(q_loc, q_logscale, p_loc, p_logscale, eps, seed, offset)


fused_sample_kl.launches = 0  # kernel launches since the caller last set it to 0
