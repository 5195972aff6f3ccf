"""K2 on the CPU: the plain version of the fused light block against the JAX
package's ``fused_light_block`` (Pallas, interpret mode) and against the JAX
light ``Block`` with converted parameters; which blocks of ukbb192 take K2;
and the wrapper's refusals that need no card.

Tolerances: float32 within 1e-5 abs + rel. In bf16 the JAX block rounds
each conv's output, then each bias add and the residual add, while K2 rounds
mid once and y once, so the two differ by about one bf16 ulp of the block's
largest output; the check is 2 ulps of max |y| (bf16 keeps 8 significant
bits, one ulp of v is 2^(floor(log2 |v|) - 7)).

The kernel itself runs only on the card: tests/test_torch_fused_block_gpu.py
and chip_smoke.py's K2 phase hold it against this plain version.
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


@pytest.mark.parametrize("c,cb,h,w", [(32, 8, 192, 192), (64, 16, 96, 96), (96, 24, 48, 48),
                                      (128, 32, 24, 24), (160, 40, 12, 12), (192, 48, 6, 6),
                                      (512, 128, 1, 1), (3, 1, 7, 13)])
def test_tiles_fit_shared_memory(c, cb, h, w):
    """Every ukbb192 block shape gets a tile within 100 KB of shared memory
    (two blocks an SM) and within the card's 227 KB."""
    th, tw, smem = k2.tile_for(c, cb, h, w)
    assert 1 <= th <= min(h, 16) and 1 <= tw <= min(w, 16)
    assert smem == k2.smem_bytes(c, cb, th, tw) <= k2.SMEM_TARGET <= k2.SMEM_LIMIT
