"""Space-to-depth conv reparameterisation for narrow-channel stages.

Counterpart of ``causal_gen_tpu/ops/s2d.py``, in NCHW with OIHW kernels. The
JAX package wrote it for the TPU's 128-lane matrix unit, where 3x3 convs of
8-64 channels pad both channel dims to the lane width; packing the 2x2
spatial phases into channels makes both 4x wider at 4x the FLOPs. It was
retired from the JAX model path, and stays off the port's: it is a plain
conv through cuDNN, which ``chip_smoke.py``'s ``tail`` phase times against
the plain conv on the card.

The reparameterisation is exact: a permutation of the data plus a sparse
embedding of the compact kernel. Pack x (B,C,H,W) -> P (B,4C,H/2,W/2) with
packed channel ``phase*C + c``, phase = 2*(y%2) + (x%2). For a SAME 3x3 conv
every tap of output phase (py, px) lands at packed offset qy = (py+dy-1)//2
in {-1, 0, 1} of input phase ry = (py+dy-1) % 2 (and likewise in x), so

    conv3x3(C->C') on x  ==  conv3x3(4C->4C') on P

with Wp[(2py+px)*C':+C', (2ry+rx)*C:+C, qy+1, qx+1] = W[:, :, dy, dx]. SAME
padding on the packed layout reproduces the original zero padding. 1x1
convs pack to a block-diagonal (4C', 4C) kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def pack_space_to_depth(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, f*f*C, H/f, W/f), channel index (phase*C + c)."""
    b, c, h, w = x.shape
    f = factor
    x = x.reshape(b, c, h // f, f, w // f, f)
    x = x.permute(0, 3, 5, 1, 2, 4)  # (B, fy, fx, C, H/f, W/f)
    return x.reshape(b, f * f * c, h // f, w // f)


def unpack_depth_to_space(p: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Inverse of :func:`pack_space_to_depth`."""
    b, cc, hh, ww = p.shape
    f = factor
    c = cc // (f * f)
    p = p.reshape(b, f, f, c, hh, ww)
    p = p.permute(0, 3, 4, 1, 5, 2)  # (B, C, H/f, fy, W/f, fx)
    return p.reshape(b, c, hh * f, ww * f)


def pack_kernel_3x3(w: torch.Tensor) -> torch.Tensor:
    """Embed a compact (Co, Ci, 3, 3) kernel into the packed (4Co, 4Ci, 3, 3)
    kernel. A scatter into zeros, so the compact kernel stays the parameter
    and its gradient is exact."""
    co, ci, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_kernel_3x3 takes a 3x3 kernel, got {tuple(w.shape)}")
    wp = w.new_zeros((4 * co, 4 * ci, 3, 3))
    for py in range(2):
        for px in range(2):
            for dy in range(3):
                for dx in range(3):
                    qy, ry = divmod(py + dy - 1, 2)
                    qx, rx = divmod(px + dx - 1, 2)
                    ph_in, ph_out = 2 * ry + rx, 2 * py + px
                    wp[ph_out * co:(ph_out + 1) * co, ph_in * ci:(ph_in + 1) * ci,
                       qy + 1, qx + 1] = w[:, :, dy, dx]
    return wp


def pack_kernel_1x1(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 1, 1) -> (4Co, 4Ci, 1, 1), block-diagonal over phases."""
    co, ci, kh, kw = w.shape
    if (kh, kw) != (1, 1):
        raise ValueError(f"pack_kernel_1x1 takes a 1x1 kernel, got {tuple(w.shape)}")
    wp = w.new_zeros((4 * co, 4 * ci, 1, 1))
    for ph in range(4):
        wp[ph * co:(ph + 1) * co, ph * ci:(ph + 1) * ci] = w
    return wp


def s2d_conv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
             packed_in: bool = False, packed_out: bool = False) -> torch.Tensor:
    """SAME stride-1 conv through the space-to-depth layout: exactly
    ``F.conv2d(x, w, bias, padding=k // 2)``.

    ``packed_in`` / ``packed_out`` skip the pack / unpack when the caller
    holds or wants the packed layout (stage-level packing). ``w`` is always
    the compact kernel."""
    k = w.shape[-1]
    if k == 3:
        wp = pack_kernel_3x3(w)
    elif k == 1:
        wp = pack_kernel_1x1(w)
    else:
        raise ValueError(f"s2d_conv supports 1x1 and 3x3 kernels, got {tuple(w.shape)}")
    p = x if packed_in else pack_space_to_depth(x)
    out = F.conv2d(p, wp.to(p.dtype), padding=k // 2)
    if bias is not None:
        # packed channel index is (phase*Co + c): tile the bias over phases
        out = out + bias.to(out.dtype).repeat(4)[None, :, None, None]
    return out if packed_out else unpack_depth_to_space(out)
