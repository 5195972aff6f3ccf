"""K3: the discretized mixture-of-logistics loss, forward and backward.

Port of ``dmol_loss_pallas`` (causal_gen_tpu/ops/pallas_kernels.py:230, kernel
``_dmol_kernel`` at :158). The JAX package takes the backward by autodiff of
the pure op (``_dmol_bwd``, :262-269); here both directions are CUDA C++
kernels for sm_90a in ``csrc/dmol_loss.cu``, built by ``ops/build.py`` and
bound with ctypes, behind one ``torch.autograd.Function``. ``plan`` chooses
their launch: one thread for each (mixture, pixel) of a tile of consecutive
flat pixels.

``dmol_loss`` launches the kernels for CUDA tensors and runs the plain op,
``ops/dmol.py::discretized_mix_logistic_loss``, with autograd for CPU tensors.
``dmol_loss_bwd_ref`` is the backward kernel's math in PyTorch, a closed form
held against autograd of the plain op. Tensors are NCHW: x (B, 3, H, W) in
[-1, 1], l (B, 10K, H, W) with K = 10 on the card. x is data: it gets no
gradient, and a CUDA call refuses an x that requires one.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor

from causal_gen_tpu_torch.ops import build
from causal_gen_tpu_torch.ops.dmol import discretized_mix_logistic_loss, dmol_logprob_pixels

MIXTURES = 10  # K compiled into csrc/dmol_loss.cu (checked against the library)
# P, consecutive flat pixels a block, as compiled into csrc/dmol_loss.cu
# (FWD_TILE, BWD_TILE): the tiles that timed fastest on an H100 (PERF.md §6)
TILE_FORWARD = 64
TILE_BACKWARD = 32


class Plan(NamedTuple):
    """A launch of one of K3's kernels."""
    tile: int  # P consecutive flat pixels a block, one thread each (mixture, pixel)
    threads: int  # K P a block
    blocks: int  # one a tile, the last one ragged
    shared_bytes: int  # dynamic: [K][P] totals, [K][P] logits, [P] and [P] sums
    straddles: bool  # some tile holds pixels of two images


def plan(n_pix: int, hw: int, backward: bool = False) -> Plan:
    """The launch of K3's forward (or backward) kernel on n_pix = B*H*W
    pixels of images of hw = H*W pixels: tiles of P consecutive flat pixels,
    one block a tile. A tile straddles two images where hw is not a multiple
    of P; its threads find their image each."""
    if n_pix < 0 or hw < 0 or (n_pix and (hw == 0 or n_pix % hw)):
        raise ValueError(f"dmol_loss: {n_pix} pixels are not whole images of {hw}")
    if n_pix >= 2 ** 31:
        raise ValueError(f"dmol_loss: {n_pix} pixels; the kernels take fewer than 2^31")
    p = TILE_BACKWARD if backward else TILE_FORWARD
    return Plan(p, MIXTURES * p, -(-n_pix // p), (2 * MIXTURES + 2) * p * 4,
                n_pix > hw and hw % p != 0)


def dmol_loss_bwd_ref(x: Tensor, l: Tensor, g: Tensor, low_bit: bool = False) -> Tensor:
    """d loss / d l (B, 10K, H, W) given ``g`` = d / d loss per image (B,):
    the backward kernel's closed form, in PyTorch (see csrc/dmol_loss.cu)."""
    b, ch, h, w = l.shape
    k = ch // 10
    lh = l.permute(0, 2, 3, 1)
    logits = lh[..., :k]
    rest = lh[..., k:].reshape(b, h, w, 3, 3 * k)
    ls_raw = rest[..., k: 2 * k]
    t = torch.tanh(rest[..., 2 * k:])
    xs = x.permute(0, 2, 3, 1)[..., None]  # (B,H,W,3,1)
    m = rest[..., :k]
    means = torch.stack([m[..., 0, :],
                         m[..., 1, :] + t[..., 0, :] * xs[..., 0, :],
                         m[..., 2, :] + t[..., 1, :] * xs[..., 0, :] + t[..., 2, :] * xs[..., 1, :]],
                        dim=-2)
    ls = torch.clamp(ls_raw, min=-7.0)
    u = xs - means
    inv = torch.exp(-ls)
    half_bin = 1.0 / 31.0 if low_bit else 1.0 / 255.0
    tail = math.log(15.5) if low_bit else math.log(127.5)
    p = inv * (u + half_bin)
    mn = inv * (u - half_bin)
    mid = inv * u
    sp, sm, smid = torch.sigmoid(p), torch.sigmoid(mn), torch.sigmoid(mid)
    cdf_delta = sp - sm
    dsp, dsm = sp * (1.0 - sp), sm * (1.0 - sm)
    # each branch: (log-prob, d/du, d/dls)
    branches = [
        (p - F.softplus(p), (1.0 - sp) * inv, -((1.0 - sp) * p)),
        (-F.softplus(mn), -(sm * inv), sm * mn),
        (torch.log(torch.clamp(cdf_delta, min=1e-12)), inv * (dsp - dsm) / cdf_delta,
         (mn * dsm - p * dsp) / cdf_delta),
        (((mid - ls) - 2.0 * F.softplus(mid)) - tail, (1.0 - 2.0 * smid) * inv,
         -((1.0 - 2.0 * smid) * mid) - 1.0),
    ]
    lo, hi, live = xs < -0.999, xs > 0.999, cdf_delta > 1e-5

    def select(i):
        a, bb, c, d = (br[i] for br in branches)
        return torch.where(lo, a, torch.where(hi, bb, torch.where(live, c, d)))

    lp, du, dls = select(0), select(1), select(2)
    m_l = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m_l)
    s = torch.sum(e, dim=-1, keepdim=True)
    total = torch.sum(lp, dim=-2) + ((logits - m_l) - torch.log(s))
    out = torch.logsumexp(total, dim=-1, keepdim=True)
    r = torch.exp(total - out)  # (B,H,W,K)
    pi = e / s
    G = -(g / (3 * h * w)).reshape(b, 1, 1, 1)
    d_logits = G * (r - pi * torch.sum(r, dim=-1, keepdim=True))
    gr = (G * r)[..., None, :]  # (B,H,W,1,K)
    d_means = -(gr * du)
    d_ls = torch.where(ls_raw >= -7.0, gr * dls, torch.zeros_like(dls))
    d_t = torch.stack([d_means[..., 1, :] * xs[..., 0, :],
                       d_means[..., 2, :] * xs[..., 0, :],
                       d_means[..., 2, :] * xs[..., 1, :]], dim=-2) * (1.0 - t * t)
    d_rest = torch.cat([d_means, d_ls, d_t], dim=-1).reshape(b, h, w, 9 * k)
    return torch.cat([d_logits, d_rest], dim=-1).permute(0, 3, 1, 2).contiguous()


@functools.cache
def _bind():
    """The kernels' C entry points, built and loaded on first use."""
    lib = build.load("dmol_loss")
    fwd, bwd = lib.dmol_forward, lib.dmol_backward
    tail = [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fwd.argtypes = [ctypes.c_void_p] * 3 + tail
    bwd.argtypes = [ctypes.c_void_p] * 4 + tail
    fwd.restype = bwd.restype = ctypes.c_int
    lib.dmol_num_mixtures.restype = ctypes.c_int
    return fwd, bwd, lib.dmol_num_mixtures()


def _check(x: Tensor, l: Tensor) -> None:
    """What the kernels take: float32 contiguous NCHW x (B,3,H,W) and
    l (B,10K,H,W) on one CUDA device, K as compiled in."""
    if l.device.type != "cuda" or x.device != l.device:
        raise ValueError(f"dmol_loss: no kernel for x on {x.device} and l on {l.device}")
    if x.dim() != 4 or l.dim() != 4 or x.shape[1] != 3 or x.shape[0] != l.shape[0] \
            or x.shape[2:] != l.shape[2:]:
        raise ValueError(f"dmol_loss: x {tuple(x.shape)} and l {tuple(l.shape)} are not "
                         "(B,3,H,W) and (B,10K,H,W)")
    k = _bind()[2]
    if k != MIXTURES:
        raise RuntimeError(f"dmol_loss: the library has {k} mixtures; plan counts {MIXTURES}")
    if l.shape[1] != 10 * k:
        raise ValueError(f"dmol_loss: the kernel is built for {k} mixtures "
                         f"({10 * k} channels); l has {l.shape[1]}")
    for name, t in (("x", x), ("l", l)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"dmol_loss: {name} must be contiguous float32, not {t.dtype}")
    if x.requires_grad:
        raise ValueError("dmol_loss: x is data; the kernel gives no gradient for it")


def dmol_logprob(x: Tensor, l: Tensor, low_bit: bool = False) -> Tensor:
    """Per-pixel mixture log-prob (B, H, W): the forward kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if l.device.type == "cpu":
        return dmol_logprob_pixels(x, l, low_bit)
    _check(x, l)
    b, _, h, w = x.shape
    out = torch.empty((b, h, w), device=l.device, dtype=torch.float32)
    pl = plan(b * h * w, h * w)
    err = _bind()[0](x.data_ptr(), l.data_ptr(), out.data_ptr(), b * h * w, h * w,
                     int(low_bit), pl.tile, pl.blocks, pl.shared_bytes,
                     torch.cuda.current_stream(l.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dmol_forward launch failed: cudaError {err}")
    dmol_logprob.launches += 1
    return out


dmol_logprob.launches = 0  # kernel launches since the caller last set it to 0


def dmol_loss_bwd(x: Tensor, l: Tensor, g: Tensor, low_bit: bool = False) -> Tensor:
    """d loss / d l given ``g`` (B,) = d / d loss per image: the backward
    kernel on CUDA tensors, ``dmol_loss_bwd_ref`` on CPU tensors."""
    if l.device.type == "cpu":
        return dmol_loss_bwd_ref(x, l, g, low_bit)
    _check(x, l)
    b, _, h, w = x.shape
    if g.shape != (b,) or g.dtype != torch.float32 or g.device != l.device:
        raise ValueError(f"dmol_loss_bwd: g is {g.dtype} {tuple(g.shape)} on {g.device}; "
                         f"expected float32 ({b},) on {l.device}")
    g = g.contiguous()
    dl = torch.empty_like(l)
    pl = plan(b * h * w, h * w, backward=True)
    err = _bind()[1](x.data_ptr(), l.data_ptr(), g.data_ptr(), dl.data_ptr(), b * h * w,
                     h * w, int(low_bit), pl.tile, pl.blocks, pl.shared_bytes,
                     torch.cuda.current_stream(l.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dmol_backward launch failed: cudaError {err}")
    dmol_loss_bwd.launches += 1
    return dl


dmol_loss_bwd.launches = 0  # kernel launches since the caller last set it to 0


class _DmolLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, l, low_bit):
        lp = dmol_logprob(x, l, low_bit)
        ctx.save_for_backward(x, l)
        ctx.low_bit = low_bit
        n_dims = math.prod(x.shape[1:])
        return -1.0 * torch.sum(lp, dim=(1, 2)) / n_dims

    @staticmethod
    def backward(ctx, g):
        x, l = ctx.saved_tensors
        return None, dmol_loss_bwd(x, l, g, ctx.low_bit), None


def dmol_loss(x: Tensor, l: Tensor, low_bit: bool = False) -> Tensor:
    """Per-image mean DMoL NLL (B,), differentiable in ``l``. CUDA tensors go
    through the two kernels; CPU tensors through the plain op and autograd."""
    if l.device.type == "cpu":
        return discretized_mix_logistic_loss(x, l, low_bit)
    _check(x, l)
    return _DmolLoss.apply(x, l, low_bit)
