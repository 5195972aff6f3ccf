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
- float32 runs ``fused_light_block_kernel_f32``: both convs as register-tiled
  implicit GEMMs on the CUDA cores in full float32 (the tensor cores have no
  full-float32 path, and TF32 would not hold float32's 1e-5 check). A lane
  holds 4 positions along a row by 8 or 16 output channels; relu(x) and mid
  sit in shared memory, x and the weights stream through it in chunks of
  input channels by cp.async; a thread-block cluster may split each conv's
  output channels among its blocks, which share mid through distributed
  shared memory. ``plan`` picks its tile, the images a block, the chunk, the
  channels a lane and the cluster by a count of lane-slots
  (``_f32_estimate``).

Bounds on the H100 at ukbb192's block shapes, bs 32, bf16 (``chip_smoke.py::
k2_bound_ms``): the bytes of x and y at 192^2 to 24^2 (45.1, 22.5, 8.5 and
2.9 us), the tensor cores' flops at 12^2 and 6^2 (1.07 and 0.39 us) and the
weights' bytes at 1^2 (0.72 us). Reached on an NVIDIA H100 80GB HBM3 at
700 W (``chip_smoke.py``, with biases): 397.6, 204.9, 92.2, 46.6, 46.8, 48.4
and 75.2 us, 17.7 ms over a ukbb192 ``DSCM.forward``'s 200 launches against
28.6 ms for cuDNN's conv pair. float32 runs on ukbb64 (the registry's dtype):
362 launches a ``DSCM.forward``, 60 an ``HVAE.sample``; its bound is float32
flops, 162.3 us at (32,32,192,192) b=8 and 18.0 us at each ukbb64 shape to
4^2 (PERF.md has the times).

``fused_light_block`` launches the kernel for CUDA tensors and runs the plain
version, ``fused_light_block_ref``, for CPU tensors; nothing gives way to the
plain version or to the other kernel on the card.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from causal_gen_tpu_torch.ops import build

SMEM_LIMIT = 232_448  # bytes of shared memory one block can have on the H100 (227 KB)
TC_MAX_SIDE, TC_MAX_AREA = 32, 512  # the tensor-core kernel's tile: sides and positions
SMS = 132  # streaming multiprocessors of the H100 SXM
ROWS_A_BLOCK = 16  # positions a block takes at least, from several images if one is smaller
PAD = 8  # bf16 elements added to every shared-memory row of the tensor-core kernel
# two tensor-core blocks of 256 threads an SM (228 KB an SM, less 1 KB the
# system keeps a block); a block above takes the SM alone, with 512 threads
SMEM_TWO_BLOCKS = 115_712
SMEM_PER_SM, SMEM_RESERVED = 233_472, 1024  # shared memory of an SM, and what a block costs more
# the float32 kernel (csrc/fused_block.cu): positions of a lane's row
# segment, threads a block; the choices of output channels a lane (NG) and
# input channels a chunk; at most 128 registers a thread; canvas pitch limit
F32_SEG = 4
F32_THREADS = 256
F32_NG = (8, 16)
F32_CLUSTERS = (1, 2, 4, 8)  # blocks of a cluster: each takes a slice of each conv's channels
F32_CHUNKS = (32, 16, 8, 4, 2, 1)
F32_REGS = 128
F32_MAX_PITCH = 128
F32_MAX_TILE = (32, 64)  # tile rows and columns the planner tries
F32_BARRIER_CLOCKS = 600  # what a barrier stalls an SM, in the planner's count


class Plan(NamedTuple):
    """How one K2 call is launched: the kernel ("tc" for bf16, "simt" for
    float32), the output tile, the images a block, the output channels the
    kernel's convs work on (C and b, padded to 16 for "tc", to ng2 and ng1
    for "simt"), the weights' staging ("resident" in shared memory for a
    whole conv, or "streamed": a tap at a time for "tc", in chunks of kc input
    channels for "simt"), the shared memory of a block in bytes and its
    threads; for "simt" also the chunk kc, the output channels of a
    lane-item in conv1 and conv2 and the blocks of a cluster, which split
    each conv's output channels."""
    kernel: str
    th: int
    tw: int
    ni: int
    cp: int
    cbp: int
    staging: str
    smem: int
    threads: int
    kc: int = 0
    ng1: int = 0
    ng2: int = 0
    cs: int = 1


class F32Layout(NamedTuple):
    """Shared memory of one float32 block (csrc/fused_block.cu F32Layout):
    taps run (9, or the centre of a 1x1 image), rows and pitch of the x and
    mid canvases, conv1's and conv2's row segments, the output channels
    padded to ng1 and ng2 and a block's slice of them, the floats of an x
    canvas (one chunk of input channels) and how many there are, of the mid
    canvas and of one of the two weight buffers."""
    taps: int
    xr: int
    xp: int
    mr: int
    mp: int
    s1: int
    s2: int
    np1: int
    np2: int
    np1s: int
    np2s: int
    xc: int
    nxc: int
    mid: int
    w: int

    @property
    def bytes(self) -> int:
        return 4 * (self.nxc * self.xc + self.mid + 2 * self.w)


def fused_light_block_ref(x: Tensor, w1: Tensor, w2: Tensor, b1: Optional[Tensor] = None,
                          b2: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch version of the kernel: both convs in float32 on values of
    x's dtype, mid and y each rounded once to x's dtype."""
    dt = x.dtype
    b1, b2 = (None if b is None else b.float() for b in (b1, b2))
    mid = F.conv2d(F.relu(x).float(), w1.float(), b1, padding=1).to(dt)
    out = F.conv2d(F.relu(mid).float(), w2.float(), b2, padding=1)
    return (x.float() + out).to(dt)


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


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def f32_layout(c: int, cb: int, h: int, w: int, th: int, tw: int, ni: int, kc: int, ng1: int,
               ng2: int, cs: int = 1) -> F32Layout:
    """Shared memory of one float32 block (csrc/fused_block.cu F32Layout).
    9 taps: an x canvas holds kc input channels of x on the tile with a
    2-pixel ring and the mid canvas relu(mid) with a 1-pixel ring, both cut 1
    pixel outside the image; ni > 1 images (whole ones) sit side by side, one
    zero column between two. A 1x1 image runs the centre tap alone: its ni
    positions make one row. Pitches are multiples of 4 with room for the last
    segment's reads; conv1 runs s1 segments of F32_SEG positions a row, conv2
    s2. Two x canvases where x takes more than one chunk, else one; then two
    buffers of kc input channels x taps x the larger conv's slice of its
    padded output channels (1/cs of them: a cluster of cs blocks splits
    them; mid stays whole in each)."""
    seg = F32_SEG
    if h == w == 1:
        taps, xr, mr = 1, 1, 1
        s1 = s2 = -(-ni // seg)
        xp = mp = seg * s1
    else:
        taps = 9
        slots = ni > 1
        mcols = ni * (w + 1) - 1 if slots else min(tw + 2, w)
        ocols = ni * (w + 1) - 1 if slots else tw
        cw = ni * (w + 1) + 1 if slots else min(tw + 4, w + 2)
        xr, mr = min(th + 4, h + 2), th + 2
        s1, s2 = -(-mcols // seg), -(-ocols // seg)
        xp, mp = _up(max(cw, seg * s1 + 2), 4), _up(max(seg * s2 + 2, seg * s1 + 1), 4)
    np1, np2 = _up(cb, ng1), _up(c, ng2)
    return F32Layout(taps, xr, xp, mr, mp, s1, s2, np1, np2, np1 // cs, np2 // cs,
                     min(kc, c) * xr * xp, 2 if c > kc else 1, cb * mr * mp,
                     kc * taps * max(np1, np2) // cs)


def _f32_conv(lay: F32Layout, rows: int, segs: int, np_: int, ng: int, k_in: int,
              kc: int) -> Tuple[float, int, int, int]:
    """One conv's count for ``_f32_estimate``: lane-slots issued, weight
    elements staged, barriers and rounds."""
    one = lay.taps == 1
    rounds = -(-(np_ // ng * rows * segs) // F32_THREADS)
    chunks = -(-k_in // kc)
    issue = rounds * F32_THREADS * lay.taps * k_in * (4 * ng + ng / 4 + (1 if one else 2 / 3))
    staged = (1 if chunks == 1 else rounds) * k_in * lay.taps * np_
    return issue, staged, rounds * chunks, rounds


def _f32_clocks(lay: F32Layout, per_sm: int, blocks: int, c: int, cs: int, conv1,
                conv2) -> float:
    """``_f32_estimate`` from the layout and both convs' counts."""
    i1, w1, n1, r1 = conv1
    i2, w2, n2, _ = conv2
    x_staged = (1 if lay.nxc == 1 else r1) * c * lay.xr * lay.xp
    gathered = lay.mid * (cs - 1) // cs  # mid's floats a block reads from the others
    lane_slots = i1 + i2 + 4 * (w1 + w2) + 3 * x_staged + lay.mid / 4 + 8 * gathered
    eff = min(1.0, per_sm * F32_THREADS / 512)
    barriers = n1 + n2 + (2 if cs > 1 else 0)
    wave = per_sm * lane_slots / (128 * eff) + F32_BARRIER_CLOCKS * barriers
    traffic = per_sm * (w1 + w2) * (32 if lay.taps == 1 else 4) / 64
    # the weights' traffic overlaps the lane-slots but for a quarter of the lesser
    return -(-blocks // (SMS * per_sm)) * (max(wave, traffic) + min(wave, traffic) / 4)


def _f32_per_sm(lay: F32Layout) -> int:
    """Blocks an SM holds: by shared memory, threads and F32_REGS registers."""
    if lay.bytes > SMEM_LIMIT or lay.xp > F32_MAX_PITCH:
        return 0
    return min(SMEM_PER_SM // (lay.bytes + SMEM_RESERVED), 2048 // F32_THREADS,
               65536 // (F32_THREADS * F32_REGS))


def _f32_estimate(b: int, c: int, cb: int, h: int, w: int, th: int, tw: int, ni: int, kc: int,
                  ng1: int, ng2: int, cs: int = 1) -> Optional[float]:
    """SM clocks a float32 launch would take by a count of its lane-slots,
    or None where it cannot launch. A lane-item's inner loop issues, for each
    input channel and tap, 4 ng fmaf and ng/4 + 2/3 shared reads; idle lanes
    of a round cost the same. Staging x and each weight element costs a few
    instructions a lane; each barrier stalls the SM F32_BARRIER_CLOCKS;
    weights come from L2 at ~64 B a clock an SM (a 32-byte sector per centre
    tap at 1x1, OIHW). Fewer than 16 warps an SM hide latency less. A cluster
    of cs blocks splits each conv's output channels and weights; each block
    stages all of x and reads the others' slices of mid (~8 lane-slots a
    float), between two more barriers."""
    lay = f32_layout(c, cb, h, w, th, tw, ni, kc, ng1, ng2, cs)
    per_sm = _f32_per_sm(lay)
    if not per_sm or (lay.np1 // ng1) % cs or (lay.np2 // ng2) % cs:
        return None
    rows1, rows2 = (1, 1) if lay.taps == 1 else (min(th + 2, h), th)
    blocks = -(-h // th) * -(-w // tw) * -(-b // ni) * cs
    return _f32_clocks(lay, per_sm, blocks, c, cs,
                       _f32_conv(lay, rows1, lay.s1, lay.np1s, ng1, c, kc),
                       _f32_conv(lay, rows2, lay.s2, lay.np2s, ng2, cb, kc))


# (B, C, b, H, W) -> (th, tw, ni, kc, ng1, ng2, cs): the fastest float32
# launch at every block shape of ukbb64 and ukbb192 at bs 32, as
# ``python3 chip_smoke.py --tune-k2`` measured it on an NVIDIA H100 80GB HBM3
# (700 W) among the estimate's best candidates (PERF.md §6)
F32_TUNED = {
    (32, 32, 8, 64, 64): (8, 64, 1, 8, 8, 8, 1),
    (32, 64, 16, 32, 32): (4, 32, 1, 8, 8, 8, 1),
    (32, 128, 32, 16, 16): (8, 16, 1, 16, 8, 8, 2),
    (32, 256, 64, 8, 8): (4, 8, 1, 16, 8, 8, 2),
    (32, 512, 128, 4, 4): (4, 4, 3, 16, 8, 8, 8),
    (32, 1024, 256, 1, 1): (1, 1, 4, 32, 8, 8, 8),
    (32, 32, 8, 192, 192): (12, 64, 1, 4, 8, 8, 1),
    (32, 64, 16, 96, 96): (12, 32, 1, 8, 8, 8, 1),
    (32, 96, 24, 48, 48): (6, 48, 1, 4, 16, 16, 1),
    (32, 128, 32, 24, 24): (6, 24, 1, 8, 8, 16, 2),
    (32, 160, 40, 12, 12): (3, 12, 1, 16, 8, 8, 1),
    (32, 192, 48, 6, 6): (3, 6, 1, 16, 8, 8, 2),
    (32, 512, 128, 1, 1): (1, 1, 3, 32, 8, 8, 8),
}


def f32_candidates(b: int, c: int, cb: int, h: int, w: int) -> List[Tuple[float, tuple]]:
    """Every float32 launch that fits, as (``_f32_estimate``, (th, tw, ni, kc,
    ng1, ng2, cs)), least estimate first, the larger tile and then the
    smaller cluster first on a tie: tiles up to F32_MAX_TILE (columns a
    multiple of 4, or the image's width), several whole images a block where
    the tile is the whole image, every chunk, output channels a lane and
    cluster that divides both convs' groups."""
    if h == w == 1:
        tiles = [(1, 1, ni) for ni in range(1, min(b, F32_MAX_PITCH) + 1)]
    else:
        tws = sorted({min(w, t) for t in range(F32_SEG, F32_MAX_TILE[1] + 1, F32_SEG)} |
                     ({w} if w <= F32_MAX_TILE[1] else set()))
        tiles = [(th, tw, 1) for th in range(1, min(h, F32_MAX_TILE[0]) + 1) for tw in tws]
        if h <= F32_MAX_TILE[0] and w <= F32_MAX_TILE[1]:
            tiles += [(h, w, ni) for ni in range(2, b + 1) if ni * (w + 1) + 1 <= F32_MAX_PITCH]
    out = []
    for th, tw, ni in tiles:
        tiles_b = -(-h // th) * -(-w // tw) * -(-b // ni)
        for kc in F32_CHUNKS:
            if kc > F32_CHUNKS[-1] and kc // 2 >= max(c, cb):
                continue  # a smaller chunk holds every channel already
            for ng1, ng2, cs in itertools.product(F32_NG, F32_NG, F32_CLUSTERS):
                if (_up(cb, ng1) // ng1) % cs or (_up(c, ng2) // ng2) % cs:
                    continue
                lay = f32_layout(c, cb, h, w, th, tw, ni, kc, ng1, ng2, cs)
                per_sm = _f32_per_sm(lay)
                if not per_sm:
                    continue
                rows1, rows2 = (1, 1) if lay.taps == 1 else (min(th + 2, h), th)
                t = _f32_clocks(lay, per_sm, tiles_b * cs, c, cs,
                                _f32_conv(lay, rows1, lay.s1, lay.np1s, ng1, c, kc),
                                _f32_conv(lay, rows2, lay.s2, lay.np2s, ng2, cb, kc))
                out.append((t, (th, tw, ni, kc, ng1, ng2, cs)))
    out.sort(key=lambda e: (e[0], -e[1][0] * e[1][1] * e[1][2], e[1][6], -e[1][3]))
    return out


def f32_plan_of(b: int, c: int, cb: int, h: int, w: int, cfg: tuple) -> Plan:
    """The float32 Plan of a launch (th, tw, ni, kc, ng1, ng2, cs)."""
    th, tw, ni, kc, ng1, ng2, cs = cfg
    lay = f32_layout(c, cb, h, w, th, tw, ni, kc, ng1, ng2, cs)
    staging = "resident" if kc >= max(c, cb) else "streamed"
    return Plan("simt", th, tw, ni, lay.np2, lay.np1, staging, lay.bytes, F32_THREADS, kc, ng1,
                ng2, cs)


@functools.lru_cache(maxsize=None)
def f32_plan(b: int, c: int, cb: int, h: int, w: int) -> Plan:
    """The float32 launch: F32_TUNED's where it has the shape, else the
    least estimate (``f32_candidates``); the smallest tile, which the caller
    refuses, where nothing fits."""
    cfg = F32_TUNED.get((b, c, cb, h, w))
    if cfg is None:
        cands = f32_candidates(b, c, cb, h, w)
        cfg = cands[0][1] if cands else (1, 1, 1, F32_CHUNKS[-1], 8, 8, 1)
    return f32_plan_of(b, c, cb, h, w, cfg)


def _halve(th: int, tw: int) -> Tuple[int, int]:
    return ((th + 1) // 2, tw) if th >= tw else (th, (tw + 1) // 2)


def plan(b: int, c: int, cb: int, h: int, w: int, dtype: torch.dtype) -> Plan:
    """The launch of K2 on x (b, c, h, w) with a bottleneck of cb channels.

    float32: the SIMT kernel at ``f32_plan``'s launch. bf16: the
    tensor-core kernel. Its tile splits the image into even tiles of sides up to 32,
    halved (the longer side first) to at most 512 positions, and halved
    again while fewer than half the SMs would get a block and the tile has
    more than 64 positions; a tile that is the whole image of fewer than 16
    positions takes several images. Both convs' weights stay resident in
    turn if they fit beside the tile, halved down to 8 x 8 as far as needed;
    else they are streamed and the tile is halved until the block fits. A
    block takes 256 threads where two fit an SM, else 512. A plan whose smem
    exceeds SMEM_LIMIT cannot launch."""
    if dtype == torch.float32:
        return f32_plan(b, c, cb, h, w)
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
    """The kernels' C entry points (float32 on the CUDA cores, bf16 on the tensor cores), built
    and loaded on first use."""
    lib = build.load("fused_block")
    f32, bf16 = lib.fused_light_block_f32_forward, lib.fused_light_block_bf16_forward
    f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 12 + [
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
    return launch(x, w1, w2, b1, b2, plan(b, c, cb, h, w, x.dtype))


def launch(x: Tensor, w1: Tensor, w2: Tensor, b1: Optional[Tensor], b2: Optional[Tensor],
           p: Plan) -> Tensor:
    """K2's kernel on checked CUDA tensors with the launch ``p`` (the plan of
    x's dtype and shape, or another one of the same kernel that fits)."""
    b, c, h, w = x.shape
    cb = w1.shape[0]
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
        err = f32(*ptrs, b, c, cb, h, w, p.th, p.tw, p.ni, p.kc, p.ng1, p.ng2, p.cs, p.smem,
                  stream)
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
