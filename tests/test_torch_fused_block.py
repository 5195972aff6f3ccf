"""K2 on the CPU: the plain version of the fused light block against the JAX
package's ``fused_light_block`` (Pallas, interpret mode) and against the JAX
light ``Block`` with converted parameters; which blocks of ukbb192 take K2;
and the wrapper's refusals that need no card.

Tolerances: float32 within 1e-5 abs + rel. In bf16 the JAX block rounds
each conv's output, then each bias add and the residual add, while K2 rounds
mid once and y once, so the two differ by about one bf16 ulp of the block's
largest output; the check is 2 ulps of max |y| (bf16 keeps 8 significant
bits, one ulp of v is 2^(floor(log2 |v|) - 7)).

The kernels themselves run only on the card: tests/test_torch_fused_block_gpu.py
and chip_smoke.py's K2 phase hold them against this plain version. Here the
launch planner, a pure function, is held to what the kernels need: for
float32 the CUDA-core kernel's tile, images a block, threads, weight chunk,
output channels a lane and shared memory, and for bf16 the tensor-core
kernel's tile, images a block, channels padded to the MMA's 16, threads and
shared memory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.models.blocks import Block as JBlock
from causal_gen_tpu.ops.fused_block import (
    flat_to_nhwc,
    fused_light_block,
    nhwc_to_flat,
    pack_weights,
)
from causal_gen_tpu_torch.config import get_config
from causal_gen_tpu_torch.models.blocks import Block
from causal_gen_tpu_torch.models.hvae import HVAE, plan_decoder_blocks
from causal_gen_tpu_torch.ops import fused_block as k2

from chip_smoke import k2_blocks_by_shape
from tests.torch_parity import load_jax_params, nchw, nhwc

torch.set_num_threads(1)


def bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _weights(rng, c, cb):
    w1 = rng.standard_normal((3, 3, c, cb)).astype(np.float32) / np.sqrt(9 * c)
    w2 = rng.standard_normal((3, 3, cb, c)).astype(np.float32) / np.sqrt(9 * cb)
    return w1, w2


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("shape", [
    (4, 8, 8, 6, 3, 4),    # B,H,W,C,CB,WC: tests/test_fused_block.py's three shapes
    (2, 5, 12, 8, 2, 4),
    (3, 16, 8, 4, 4, 8),
    (2, 8, 8, 16, 4, 4),   # b = C/4, as in every model block
])
def test_plain_version_matches_the_pallas_kernel(shape):
    b, h, w, c, cb, wc = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    w1, w2 = _weights(rng, c, cb)
    t1, t2 = pack_weights(jnp.asarray(w1), jnp.asarray(w2))
    ref = flat_to_nhwc(fused_light_block(nhwc_to_flat(jnp.asarray(x)), t1, t2, B=b, WC=wc,
                                         interpret=True), b)
    got = k2.fused_light_block(nchw(x), _oihw(w1), _oihw(w2))  # CPU: the plain version
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _block_pair(c, cb, bf16, seed=1):
    """The JAX light Block and the port's with the same parameters; biases
    and the last conv made non-trivial."""
    dtype = jnp.bfloat16 if bf16 else None
    jb = JBlock(in_width=c, bottleneck=cb, out_width=c, version="light", dtype=dtype)
    x0 = jnp.zeros((1, 4, 4, c))
    params = jb.init(jax.random.PRNGKey(seed), x0)["params"]
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 8))
    params = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(next(keys), a.shape), params)
    tb = Block(c, cb, c, version="light", dtype=torch.bfloat16 if bf16 else None)
    load_jax_params(tb, params)
    return jb, params, tb


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 4), (3, 5, 12, 8, 2), (2, 1, 1, 32, 8),
                                   (2, 16, 16, 32, 8)])
def test_covered_block_matches_the_jax_block(shape, bf16):
    """A covered block outside autograd runs K2 (its plain version here), with
    the convs' biases; with autograd recording it runs its convs one by one.
    Both against the JAX Block."""
    b, h, w, c, cb = shape
    jb, params, tb = _block_pair(c, cb, bf16)
    x = np.random.default_rng(2).standard_normal((b, h, w, c)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    ref = np.asarray(jb.apply({"params": params}, xj).astype(jnp.float32))
    xt = nchw(x).to(torch.bfloat16 if bf16 else torch.float32)
    with torch.no_grad():
        assert tb.takes_k2(xt)
        fused = tb(xt)
    assert not tb.takes_k2(xt)  # autograd records here
    per_op = tb(xt).detach()
    for got in (fused, per_op):
        assert got.dtype == xt.dtype
        if bf16:
            err = np.abs(nhwc(got.float()) - ref).max()
            assert err <= 2 * bf16_ulp(np.abs(ref).max()), err
        else:
            np.testing.assert_allclose(nhwc(got), ref, rtol=1e-5, atol=1e-5)


def _k2_blocks(cfg):
    """(encoder blocks, decoder conv blocks) that K2 covers, and their totals."""
    vae = HVAE(cfg, device="meta")
    enc = [blk.k2_covered for blk in vae.encoder._blocks]
    dec = [blk.conv.k2_covered for blk in vae.decoder._blocks]
    others = [blk.k2_covered for d in vae.decoder._blocks
              for blk in (d.prior, getattr(d, "posterior", None)) if blk is not None]
    return enc, dec, others


def test_which_ukbb192_blocks_take_k2():
    """34 encoder blocks: every non-down block of 192b1d2,96b3d2,48b7d2,
    24b11d2,12b7d2,6b3d6,1b2 (the two at 1x1 included). 33 of the 40 decoder
    conv blocks: not the 6 that end a stage (width_proj) nor the k=1 blocks at
    res <= 2. No prior or posterior block (residual=False)."""
    cfg = get_config("ukbb192")
    enc, dec, others = _k2_blocks(cfg)
    assert (sum(enc), len(enc)) == (34, 40)
    assert (sum(dec), len(dec)) == (33, 40)
    assert not any(others)
    stages = plan_decoder_blocks(cfg)
    for i, ((res, width), covered) in enumerate(zip(stages, dec)):
        next_width = stages[min(len(stages) - 1, i + 1)][1]
        assert covered == (res > 2 and next_width == width), i
    # per DSCM.forward (1 particle): 2 encoder + 4 decoder passes
    assert 2 * sum(enc) + 4 * sum(dec) == 200


def test_wrapper_refuses_a_device_without_a_kernel():
    x = torch.zeros(1, 4, 3, 3, device="meta")
    w1, w2 = torch.zeros(1, 4, 3, 3, device="meta"), torch.zeros(4, 1, 3, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k2.fused_light_block(x, w1, w2)


def test_which_ukbb64_blocks_take_k2():
    """ukbb64 (float32, the registry's dtype) runs K2's float32 kernel on
    every covered block: by (C, b, res), encoder and decoder blocks, 362
    launches a DSCM.forward (2 encoder + 4 decoder passes) and 60 an
    HVAE.sample (one decoder pass)."""
    cfg = get_config("ukbb64")
    assert cfg.dtype == "float32" and cfg.block_version == "light"
    by_shape = k2_blocks_by_shape(cfg, HVAE(cfg, device="meta"))
    assert by_shape == {(32, 8, 64): [3, 4], (64, 16, 32): [31, 31], (128, 32, 16): [15, 15],
                        (256, 64, 8): [7, 7], (512, 128, 4): [3, 3], (1024, 256, 1): [2, 0]}
    assert sum(2 * e + 4 * d for e, d in by_shape.values()) == 362
    assert sum(d for _, d in by_shape.values()) == 60


@pytest.mark.parametrize("c,cb,h,w", [(32, 8, 192, 192), (64, 16, 96, 96), (96, 24, 48, 48),
                                      (128, 32, 24, 24), (160, 40, 12, 12), (192, 48, 6, 6),
                                      (512, 128, 1, 1), (3, 1, 7, 13)])
def test_tiles_fit_shared_memory(c, cb, h, w):
    """Every ukbb192 block shape gets a float32 tile inside the image whose
    canvases and weight buffers fit the card's 227 KB, at least one block an
    SM."""
    p = k2.plan(32, c, cb, h, w, torch.float32)
    assert 1 <= p.th <= h and 1 <= p.tw <= w
    assert p.smem == k2.f32_layout(c, cb, h, w, p.th, p.tw, p.ni, p.kc, p.ng1, p.ng2,
                                   p.cs).bytes
    assert p.smem + k2.SMEM_RESERVED <= k2.SMEM_PER_SM and p.smem <= k2.SMEM_LIMIT


UKBB_SHAPES = [(32, 32, 8, 192, 192), (32, 64, 16, 96, 96), (32, 96, 24, 48, 48),
               (32, 128, 32, 24, 24), (32, 160, 40, 12, 12), (32, 192, 48, 6, 6),
               (32, 512, 128, 1, 1)]  # (B, C, b, H, W) of every block K2 covers in ukbb192
ODD_SHAPES = [(3, 8, 2, 7, 13), (2, 48, 12, 9, 11), (5, 24, 8, 2, 3), (2, 512, 128, 5, 4),
              (1, 3, 1, 1, 1), (20, 512, 128, 1, 1)]


@pytest.mark.parametrize("shape", UKBB_SHAPES + ODD_SHAPES)
def test_bf16_plan_fits_the_tensor_core_kernel(shape):
    """bf16 takes the tensor-core kernel: channels padded to the MMA's k of
    16, a tile inside the image, several images a block only where the tile
    is the whole image, shared memory as the kernel lays it out and within
    227 KB, 256 threads where two blocks fit an SM and 512 where one does."""
    b, c, cb, h, w = shape
    p = k2.plan(b, c, cb, h, w, torch.bfloat16)
    assert p.kernel == "tc"
    assert p.cp % 16 == 0 and c <= p.cp < c + 16 and p.cbp % 16 == 0 and cb <= p.cbp < cb + 16
    assert 1 <= p.th <= h and 1 <= p.tw <= w and p.th * p.tw <= k2.TC_MAX_AREA
    assert 1 <= p.ni <= b and (p.ni == 1 or (p.th, p.tw) == (h, w))
    assert p.smem == k2.tc_smem_bytes(c, cb, h, w, p.th, p.tw, p.ni, p.staging == "resident")
    assert p.smem <= k2.SMEM_LIMIT
    assert p.threads == (256 if p.smem <= k2.SMEM_TWO_BLOCKS else 512)
    if shape in UKBB_SHAPES:
        assert p.staging == "resident"


def test_plan_shapes_at_ukbb192_and_past_the_shared_memory():
    """The tiles the planner picks for ukbb192, the shared memory of the
    hottest shape counted by hand, the centre tap alone at 1x1 and weights
    that must be streamed when they do not fit beside a tile."""
    tiles = [k2.plan(*s, torch.bfloat16)[1:4] for s in UKBB_SHAPES]
    assert tiles == [(16, 32, 1), (16, 32, 1), (12, 24, 1), (12, 12, 1), (6, 6, 1), (6, 6, 1),
                     (1, 1, 16)]
    # 16 x 32 tile of (32,32,192,192) b=8, in bf16 elements: a zero row of 32 + 8;
    # x 20 x 36 positions of 32 + 8; mid 18 x 34 of 16 + 8; the larger conv's
    # weights, 9 taps x 32 rows x (16 + 8)
    assert k2.plan(*UKBB_SHAPES[0], torch.bfloat16).smem == 2 * (
        40 + 20 * 36 * 40 + 18 * 34 * 24 + 9 * 32 * 24)
    # 1x1: 16 images, only the centre tap's weights: max(128 x 520, 512 x 136)
    assert k2.plan(*UKBB_SHAPES[6], torch.bfloat16).smem == 2 * (
        520 + 16 * 520 + 16 * 136 + max(128 * 520, 512 * 136))
    assert k2.plan(2, 512, 128, 5, 4, torch.bfloat16).staging == "streamed"
    assert k2.plan(1, 4096, 1024, 3, 3, torch.bfloat16).smem > k2.SMEM_LIMIT  # refused


UKBB64_SHAPES = [(32, 32, 8, 64, 64), (32, 64, 16, 32, 32), (32, 128, 32, 16, 16),
                 (32, 256, 64, 8, 8), (32, 512, 128, 4, 4),
                 (32, 1024, 256, 1, 1)]  # (B, C, b, H, W) of every block K2 covers in ukbb64


@pytest.mark.parametrize("shape", UKBB_SHAPES + ODD_SHAPES + UKBB64_SHAPES)
def test_float32_plan_is_the_simt_kernel(shape):
    """float32 takes the CUDA-core kernel: a tile inside the image, several
    images a block only where the tile is the whole image, 256 threads, one
    of the compiled chunks and output channels a lane, the convs' output
    channels padded to those, shared memory as the kernel lays it out and
    within 227 KB, a canvas pitch the staging covers, the weights resident
    only where one chunk holds every input channel, and the least estimate
    over every choice at its tile."""
    b, c, cb, h, w = shape
    p = k2.plan(b, c, cb, h, w, torch.float32)
    assert p.kernel == "simt"
    assert 1 <= p.th <= h and 1 <= p.tw <= w and 1 <= p.ni <= b
    assert p.ni == 1 or (p.th, p.tw) == (h, w)
    assert p.threads == k2.F32_THREADS and p.kc in k2.F32_CHUNKS
    assert p.ng1 in k2.F32_NG and p.ng2 in k2.F32_NG
    assert (p.cp, p.cbp) == (-(-c // p.ng2) * p.ng2, -(-cb // p.ng1) * p.ng1)
    lay = k2.f32_layout(c, cb, h, w, p.th, p.tw, p.ni, p.kc, p.ng1, p.ng2, p.cs)
    assert p.smem == lay.bytes <= k2.SMEM_LIMIT and lay.xp <= k2.F32_MAX_PITCH
    assert lay.taps == (1 if (h, w) == (1, 1) else 9)
    assert p.staging == ("resident" if p.kc >= max(c, cb) else "streamed")
    # a cluster splits each conv's groups of output channels evenly
    assert p.cs in k2.F32_CLUSTERS and (p.cp // p.ng2) % p.cs == 0 == (p.cbp // p.ng1) % p.cs
    cfg = (p.th, p.tw, p.ni, p.kc, p.ng1, p.ng2, p.cs)
    if shape in k2.F32_TUNED:  # the measured table's launch, one the estimate also offers
        assert cfg == k2.F32_TUNED[shape]
        assert cfg in [c_ for _, c_ in k2.f32_candidates(*shape)]
    else:  # the estimate's least over every choice at this tile
        best = min(k2._f32_estimate(b, c, cb, h, w, p.th, p.tw, p.ni, kc, ng1, ng2, cs)
                   or float("inf") for kc in k2.F32_CHUNKS for ng1 in k2.F32_NG
                   for ng2 in k2.F32_NG for cs in k2.F32_CLUSTERS)
        assert k2._f32_estimate(b, c, cb, h, w, *cfg) == best


def test_float32_tuned_launches_cover_the_ukbb_shapes():
    """F32_TUNED holds one launch for every bs-32 block shape of ukbb64 and
    ukbb192, and nothing else."""
    assert set(k2.F32_TUNED) == set(UKBB_SHAPES + UKBB64_SHAPES)


def test_float32_layout_counted_by_hand():
    """The float32 block's shared memory at three geometries, in floats: x
    canvases of a chunk of input channels (channels x rows x pitch; two of
    them where x takes more than one chunk), mid canvas, two weight buffers
    (of the block's slice of output channels in a cluster)."""
    # a 16 x 32 tile of (32,32,192,192) b=8: x 20 rows of 36 columns, 9
    # conv1 segments read to column 37 (pitch 40); mid 18 rows, 8 conv2
    # segments read to 33, conv1 writes to 36 (pitch 40); chunks of 8
    # channels x 9 taps x 32 outputs
    lay = k2.f32_layout(32, 8, 192, 192, 16, 32, 1, 8, 8, 16)
    assert (lay.xr, lay.xp, lay.mr, lay.mp, lay.s1, lay.s2) == (20, 40, 18, 40, 9, 8)
    assert lay.bytes == 4 * (2 * 8 * 20 * 40 + 8 * 18 * 40 + 2 * 8 * 9 * 32)
    # 1x1: 16 images in one row, the centre tap only; a cluster of 4 blocks
    # stages a quarter of each conv's output channels' weights
    lay = k2.f32_layout(512, 128, 1, 1, 1, 1, 16, 32, 8, 8, 4)
    assert (lay.taps, lay.xr, lay.xp, lay.s1, lay.np1s, lay.np2s) == (1, 1, 16, 4, 32, 128)
    assert lay.bytes == 4 * (2 * 32 * 16 + 128 * 16 + 2 * 32 * 128)
    # 4 whole 2 x 3 images side by side, one zero column between two; x in one chunk
    lay = k2.f32_layout(24, 8, 2, 3, 2, 3, 4, 32, 8, 16)
    assert (lay.xr, lay.xp, lay.mr, lay.mp, lay.np1, lay.np2) == (4, 20, 4, 20, 8, 32)
    assert lay.bytes == 4 * (24 * 4 * 20 + 8 * 4 * 20 + 2 * 32 * 9 * 32)


def test_plan_refuses_a_dtype_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        k2.plan(2, 8, 2, 5, 5, torch.float16)
