"""K2: the body of the "light" residual block in one pass.

Port of ``fused_light_block`` (causal_gen_tpu/ops/fused_block.py:190, kernel
``_fused_light_block_kernel`` at :51): CUDA C++ kernels for sm_90a in
``csrc/fused_block.cu``, built by ``ops/build.py`` and bound with ctypes.

    y = x + conv3x3(relu(conv3x3(relu(x), w1) + b1), w2) + b2

with "SAME" zero padding, float32 accumulation, mid rounded once to x's
dtype and y = x + acc rounded once (the JAX kernel's ``mid_ring`` and
``acc + res.astype(f32)``). It differs from the JAX kernel in three ways: the
biases are optional (with none it is the JAX function), tensors are NCHW with
OIHW weights instead of the TPU's (H, C, W*B) ring layout, and the storage
type is float32 or bf16. Like the JAX kernel it has no gradient.

The storage type alone chooses the kernel, and nothing else does:

- bf16 runs ``fused_light_block_kernel_tc``: both convs as implicit GEMMs on
  the tensor cores (``mma.sync`` m16n8k16, float32 accumulation), x staged
  once in shared memory as bf16 with channels innermost and zero-padded to 16,
  the weights repacked there by the kernel, mid kept in shared memory, the
  residual read from the staged tile. ``plan`` picks its tile, the images a
  block and whether each conv's weights stay in shared memory for the whole
  conv or are streamed a tap at a time (see the source's note).
- float32 runs ``fused_light_block_kernel<float>``, PR 7's SIMT kernel: float32
  FMAs on the CUDA cores (the tensor cores have no full-float32 path, and
  TF32 would not hold float32's 1e-5 check). ``tile_for`` picks its tile.

Bounds on the H100 at ukbb192's block shapes, bs 32, bf16 (``chip_smoke.py::
k2_bound_ms``): the bytes of x and y at 192^2 to 24^2 (45.1, 22.5, 8.5 and
2.9 us), the tensor cores' flops at 12^2 and 6^2 (1.07 and 0.39 us) and the
weights' bytes at 1^2 (0.72 us). Reached on an NVIDIA H100 80GB HBM3 at
700 W (``chip_smoke.py``, with biases): 397.6, 204.9, 92.2, 46.6, 46.8, 48.4
and 75.2 us, 17.7 ms over a ukbb192 ``DSCM.forward``'s 200 launches against
28.6 ms for cuDNN's conv pair; float32 2153.8 us at (32,32,192,192) b=8.

``fused_light_block`` launches the kernel for CUDA tensors and runs the plain
version, ``fused_light_block_ref``, for CPU tensors; nothing gives way to the
plain version or to the other kernel on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from causal_gen_tpu_torch.ops import build

SMEM_LIMIT = 232_448  # bytes of shared memory one block can have on the H100 (227 KB)
SMEM_TARGET = 100 * 1024  # the SIMT tile is cut down to this where it can be: 2 blocks an SM
MAX_TILE = 16  # the SIMT kernel's tile side
TC_MAX_SIDE, TC_MAX_AREA = 32, 512  # the tensor-core kernel's tile: sides and positions
SMS = 132  # streaming multiprocessors of the H100 SXM
ROWS_A_BLOCK = 16  # positions a block takes at least, from several images if one is smaller
PAD = 8  # bf16 elements added to every shared-memory row of the tensor-core kernel
# two tensor-core blocks of 256 threads an SM (228 KB an SM, less 1 KB the
# system keeps a block); a block above takes the SM alone, with 512 threads
SMEM_TWO_BLOCKS = 115_712


class Plan(NamedTuple):
    """How one K2 call is launched: the kernel ("tc" for bf16, "simt" for
    float32), the output tile, the images a block, the channel counts the
    kernel works on (padded to 16 for "tc"), the weights' staging ("resident"
    in shared memory for a whole conv, "streamed" a tap at a time, or
    "global": read from device memory by the SIMT kernel), the shared memory
    of a block in bytes and its threads."""
    kernel: str
    th: int
    tw: int
    ni: int
    cp: int
    cbp: int
    staging: str
    smem: int
    threads: int


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
    """Shared memory of one SIMT block: relu(x) with a 2-pixel halo and
    relu(mid) with a 1-pixel halo, as float32."""
    return 4 * (c * (th + 4) * (tw + 4) + cb * (th + 2) * (tw + 2))


def tile_for(c: int, cb: int, h: int, w: int) -> Tuple[int, int, int]:
    """(TH, TW, shared bytes) of a SIMT launch: up to 16 x 16, halved along
    the longer side until the shared memory is under SMEM_TARGET or the tile
    is one pixel."""
    th, tw = min(h, MAX_TILE), min(w, MAX_TILE)
    while smem_bytes(c, cb, th, tw) > SMEM_TARGET and th * tw > 1:
        if th >= tw:
            th = (th + 1) // 2
        else:
            tw = (tw + 1) // 2
    return th, tw, smem_bytes(c, cb, th, tw)


def _ceil16(v: int) -> int:
    return -(-v // 16) * 16


def _ceil32(v: int) -> int:
    return -(-v // 32) * 32


def tc_smem_bytes(c: int, cb: int, h: int, w: int, th: int, tw: int, ni: int,
                  resident: bool) -> int:
    """Shared memory of one tensor-core block (csrc/fused_block.cu TcLayout):
    a zero row; x with a 2-pixel halo and mid with a 1-pixel halo, both cut at
    the image's edge, of ni images, channels padded to 16 and rows by PAD; and
    one conv's weights at a time, for every tap the image needs and every
    pass (resident) or one tap of a pass (streamed). A conv1 pass is 32 mid
    channels where b padded to 16 is a multiple of 32, else 16; a conv2 pass
    is 32 output channels."""
    cp, cbp = _ceil16(c), _ceil16(cb)
    taps = (3 if h > 1 else 1) * (3 if w > 1 else 1)
    xs = ni * min(th + 4, h) * min(tw + 4, w) * (cp + PAD)
    ms = ni * min(th + 2, h) * min(tw + 2, w) * (cbp + PAD)
    pass1 = 32 if cbp % 32 == 0 else 16
    r1, r2, t = (cbp, _ceil32(c), taps) if resident else (pass1, 32, 1)
    ws = max(t * r1 * (cp + PAD), t * r2 * (cbp + PAD))
    return 2 * (max(cp, cbp) + PAD + xs + ms + ws)


def _halve(th: int, tw: int) -> Tuple[int, int]:
    return ((th + 1) // 2, tw) if th >= tw else (th, (tw + 1) // 2)


def plan(b: int, c: int, cb: int, h: int, w: int, dtype: torch.dtype) -> Plan:
    """The launch of K2 on x (b, c, h, w) with a bottleneck of cb channels.

    float32: the SIMT kernel at ``tile_for``'s tile. bf16: the tensor-core
    kernel. Its tile splits the image into even tiles of sides up to 32,
    halved (the longer side first) to at most 512 positions, and halved
    again while fewer than half the SMs would get a block and the tile has
    more than 64 positions; a tile that is the whole image of fewer than 16
    positions takes several images. Both convs' weights stay resident in
    turn if they fit beside the tile, halved down to 8 x 8 as far as needed;
    else they are streamed and the tile is halved until the block fits. A
    block takes 256 threads where two fit an SM, else 512. A plan whose smem
    exceeds SMEM_LIMIT cannot launch."""
    if dtype == torch.float32:
        th, tw, smem = tile_for(c, cb, h, w)
        return Plan("simt", th, tw, 1, c, cb, "global", smem, 256)
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_light_block: no kernel for {dtype}")
    th, tw = -(-h // -(-h // TC_MAX_SIDE)), -(-w // -(-w // TC_MAX_SIDE))
    while th * tw > TC_MAX_AREA:
        th, tw = _halve(th, tw)
    while b * -(-h // th) * -(-w // tw) < SMS // 2 and th * tw > 64:
        th, tw = _halve(th, tw)
    ni = max(1, min(b, ROWS_A_BLOCK // (h * w))) if (th, tw) == (h, w) else 1
    cp, cbp = _ceil16(c), _ceil16(cb)

    def smem(t, res):
        return tc_smem_bytes(c, cb, h, w, *t, ni, res)

    def made(t, res):
        b = smem(t, res)
        return Plan("tc", *t, ni, cp, cbp, "resident" if res else "streamed", b,
                    256 if b <= SMEM_TWO_BLOCKS else 512)

    t = (th, tw)
    while smem(t, True) > SMEM_LIMIT and t[0] * t[1] > 64:
        t = _halve(*t)
    if smem(t, True) <= SMEM_LIMIT:
        return made(t, True)
    t = (th, tw)
    while smem(t, False) > SMEM_LIMIT and t[0] * t[1] > 1:
        t = _halve(*t)
    return made(t, False)


@functools.cache
def _bind():
    """The kernels' C entry points (float32 SIMT, bf16 tensor cores), built
    and loaded on first use."""
    lib = build.load("fused_block")
    f32, bf16 = lib.fused_light_block_f32_forward, lib.fused_light_block_bf16_forward
    f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    f32.restype = bf16.restype = ctypes.c_int
    return f32, bf16


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
    the biases (b,) and (C,) may be None. bf16 launches the tensor-core
    kernel, float32 the SIMT kernel. A CPU call runs
    ``fused_light_block_ref``."""
    if x.device.type == "cpu":
        return fused_light_block_ref(x, w1, w2, b1, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_light_block: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
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
    p = plan(b, c, cb, h, w, x.dtype)
    if p.smem > SMEM_LIMIT:
        raise ValueError(f"fused_light_block: C={c}, b={cb} needs {p.smem} B of shared memory "
                         f"even at a {p.th}x{p.tw} tile; the card has {SMEM_LIMIT}")
    if -(-b // p.ni) > 65535:
        raise ValueError(f"fused_light_block: batch {b} exceeds the grid's 65535 blocks")
    y = torch.empty_like(x)
    f32, bf16 = _bind()
    ptrs = (x.data_ptr(), w1.data_ptr(), None if b1 is None else b1.data_ptr(),
            w2.data_ptr(), None if b2 is None else b2.data_ptr(), y.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p.kernel == "tc":
        err = bf16(*ptrs, b, c, cb, h, w, p.th, p.tw, p.ni, int(p.staging == "resident"),
                   p.threads, p.smem, stream)
    else:
        err = f32(*ptrs, b, c, cb, h, w, p.th, p.tw, p.smem, stream)
    if err != 0:
        raise RuntimeError(f"fused_light_block ({p.kernel}) launch failed: cudaError {err}")
    fused_light_block.launches += 1
    if p.kernel == "tc":
        fused_light_block.launches_tc += 1
    else:
        fused_light_block.launches_simt += 1
    return y


# kernel launches since the caller last set them to 0: all, the bf16
# tensor-core kernel's and the float32 SIMT kernel's
fused_light_block.launches = 0
fused_light_block.launches_tc = 0
fused_light_block.launches_simt = 0
