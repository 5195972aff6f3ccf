"""K1: fused reparameterised Gaussian sample + per-element Gaussian KL.

Port of ``fused_sample_kl`` (causal_gen_tpu/ops/pallas_kernels.py:109, kernel
``_sample_kl_kernel`` at :54, custom VJP ``_fskl_fwd``/``_fskl_bwd`` at
:131-147). Both directions are CUDA C++ kernels for sm_90a in
``csrc/sample_kl.cu``, built by ``ops/build.py`` and bound with ctypes.

``fused_sample_kl`` and ``fused_sample_kl_bwd`` launch their kernels for CUDA
tensors and run the plain versions, ``fused_sample_kl_ref`` and
``fused_sample_kl_bwd_ref``, for CPU tensors; nothing gives way to a plain
version on the card. The forward saves ``z``, not ``eps`` (the Philox path
never stores eps), and the backward recovers the reparameterisation term as
``gz * (z - q_loc)``, as the JAX VJP does.
"""

from __future__ import annotations

import ctypes
import functools
import math
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


def fused_sample_kl_bwd_ref(
    q_loc: Tensor, q_logscale: Tensor, p_loc: Tensor, p_logscale: Tensor, z: Tensor,
    gz: Tensor, gkl: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the backward kernel: ``_fskl_bwd``
    (pallas_kernels.py:136-147) in the same order. Returns the cotangents of
    (q_loc, q_logscale, p_loc, p_logscale); ``gz`` and ``gkl`` broadcast."""
    s_q2 = torch.exp(q_logscale) ** 2
    inv_p2 = torch.exp(-p_logscale) ** 2
    diff = q_loc - p_loc
    d_qloc = gz + gkl * diff * inv_p2
    d_qlog = gz * (z - q_loc) + gkl * (s_q2 * inv_p2 - 1.0)
    d_ploc = -(gkl * diff * inv_p2)
    d_plog = gkl * (1.0 - (s_q2 + diff**2) * inv_p2)
    return d_qloc, d_qlog, d_ploc, d_plog


@functools.cache
def _bind():
    """The kernels' C entry points, built and loaded on first use."""
    lib = build.load("sample_kl")
    fwd = lib.sample_kl_forward
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_uint64,
                                            ctypes.c_uint64, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.sample_kl_backward
    bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(name: str, t: Tensor, like: Tensor, contiguous: bool = True) -> None:
    if t.device != like.device or t.dtype != torch.float32 or t.shape != like.shape:
        raise ValueError(
            f"fused_sample_kl: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
            f"expected float32 {tuple(like.shape)} on {like.device}"
        )
    if contiguous and not t.is_contiguous():
        raise ValueError(f"fused_sample_kl: {name} must be contiguous")


def _launch(q_loc, q_logscale, p_loc, p_logscale, eps, seed, offset):
    fn = _bind()[0]
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


def _per_row(g: Tensor) -> Tuple[Tensor, int]:
    """(values, rep) such that element i of ``g`` is ``values[i // rep]``.

    The KL is summed over space where it is drawn (hvae.py), so its cotangent
    arrives as a stride-0 broadcast over the trailing spatial axes: the kernel
    then reads the (B, C) values, not a materialised map."""
    if g.dim() >= 3 and all(st == 0 for st in g.stride()[2:]):
        return g[(slice(None), slice(None)) + (0,) * (g.dim() - 2)].contiguous(), \
            math.prod(g.shape[2:])
    return g.contiguous(), 1


def fused_sample_kl_bwd(
    q_loc: Tensor, q_logscale: Tensor, p_loc: Tensor, p_logscale: Tensor, z: Tensor,
    gz: Optional[Tensor], gkl: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Cotangents of (q_loc, q_logscale, p_loc, p_logscale) given those of
    (z, kl). A CUDA call launches the backward kernel; ``gz`` or ``gkl`` may be
    None (an output no loss reads) or any strided tensor of the inputs' shape.
    A CPU call runs ``fused_sample_kl_bwd_ref``."""
    if q_loc.device.type == "cpu":
        zero = torch.zeros((), dtype=q_loc.dtype)
        return fused_sample_kl_bwd_ref(q_loc, q_logscale, p_loc, p_logscale, z,
                                       zero if gz is None else gz,
                                       zero if gkl is None else gkl)
    if q_loc.device.type != "cuda":
        raise ValueError(f"fused_sample_kl_bwd: no kernel for device {q_loc.device}")
    for name, t in (("q_loc", q_loc), ("q_logscale", q_logscale), ("p_loc", p_loc),
                    ("p_logscale", p_logscale), ("z", z)):
        _check(name, t, q_loc)
    if gz is not None:
        _check("gz", gz, q_loc, contiguous=False)
        gz = gz.contiguous()
    rep = 1
    if gkl is not None:
        _check("gkl", gkl, q_loc, contiguous=False)
        gkl, rep = _per_row(gkl)
    outs = [torch.empty_like(q_loc) for _ in range(4)]
    err = _bind()[1](q_loc.data_ptr(), q_logscale.data_ptr(), p_loc.data_ptr(),
                     p_logscale.data_ptr(), z.data_ptr(),
                     None if gz is None else gz.data_ptr(),
                     None if gkl is None else gkl.data_ptr(), rep,
                     *(o.data_ptr() for o in outs), q_loc.numel(),
                     torch.cuda.current_stream(q_loc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sample_kl_backward launch failed: cudaError {err}")
    fused_sample_kl_bwd.launches += 1
    return tuple(outs)


fused_sample_kl_bwd.launches = 0  # kernel launches since the caller last set it to 0


class _FusedSampleKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_loc, q_logscale, p_loc, p_logscale, eps, seed, offset):
        z, kl = _launch(q_loc, q_logscale, p_loc, p_logscale, eps, seed, offset)
        ctx.save_for_backward(q_loc, q_logscale, p_loc, p_logscale, z)
        ctx.set_materialize_grads(False)
        return z, kl

    @staticmethod
    def backward(ctx, gz, gkl):
        if gz is None and gkl is None:
            return (None,) * 7
        grads = fused_sample_kl_bwd(*ctx.saved_tensors, gz, gkl)
        return grads + (None, None, None)


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
