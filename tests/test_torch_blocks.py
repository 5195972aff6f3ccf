"""The port's conv blocks and encoder against the JAX package's, with
converted parameters, on NHWC inputs permuted to NCHW (1e-5 abs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.models import blocks as jb
from causal_gen_tpu_torch.models import blocks as tb

from tests.torch_parity import load_jax_params, nchw, nhwc

torch.set_num_threads(1)


def _jax_block_out(module, x_nhwc, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc))["params"]
    return params, np.asarray(module.apply({"params": params}, jnp.asarray(x_nhwc)))


@pytest.mark.parametrize(
    "version,in_w,out_w,k,down,residual",
    [
        (None, 8, 8, 3, None, True),  # GELU body, identity residual
        (None, 8, 16, 3, 2, True),  # GELU body, width_proj + avg-pool
        (None, 12, 10, 1, None, False),  # 1x1 prior/posterior-style head
        ("light", 8, 8, 3, None, True),  # light body
        ("light", 8, 12, 3, 2, True),  # light body, width_proj + avg-pool
    ],
)
def test_block_matches_jax(version, in_w, out_w, k, down, residual):
    x = np.random.default_rng(0).normal(0, 1, (2, 8, 8, in_w)).astype(np.float32)
    jblock = jb.Block(in_width=in_w, bottleneck=4, out_width=out_w, kernel_size=k,
                      residual=residual, down_rate=down, version=version, last_scale=0.7)
    params, ref = _jax_block_out(jblock, x)
    tblock = tb.Block(in_w, 4, out_w, k, residual=residual, down_rate=down, version=version)
    load_jax_params(tblock, params)
    with torch.no_grad():
        out = tblock(nchw(x))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-5)


def test_block_gelu_is_exact_erf():
    """The GELU body uses erf GELU: the tanh approximation moves the output by
    far more than the tolerance at these inputs."""
    x = np.random.default_rng(1).normal(0, 2, (2, 4, 4, 8)).astype(np.float32)
    jblock = jb.Block(in_width=8, bottleneck=8, out_width=8, kernel_size=3)
    params, ref = _jax_block_out(jblock, x, seed=1)
    tblock = tb.Block(8, 8, 8, 3)
    load_jax_params(tblock, params)
    with torch.no_grad():
        out = nhwc(tblock(nchw(x)))
        xt = nchw(x)
        approx = xt
        for c in tblock._convs:
            approx = c(torch.nn.functional.gelu(approx, approximate="tanh"))
        approx = nhwc(xt + approx)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert np.abs(approx - ref).max() > 1e-4


@pytest.mark.parametrize(
    "enc_arch,res,widths",
    [
        ("16b1d2,8b1d2,4b1d4,1b1", 16, (8, 8, 16, 16)),  # the small Morpho-MNIST encoder
        ("12b1d2,6b1d2,3b1d3,1b1", 12, (8, 8, 8, 16)),  # res 3 is odd: (0,1) pad to 4
        ("16b0,8b1d2,4b1d4,1b1", 16, (8, 8, 16, 16)),  # empty stage 0: stride-2 stem
    ],
)
def test_encoder_matches_jax(enc_arch, res, widths):
    from causal_gen_tpu.config import parse_enc_arch as jparse
    from causal_gen_tpu_torch.config import parse_enc_arch as tparse

    x = np.random.default_rng(2).uniform(-1, 1, (2, res, res, 1)).astype(np.float32)
    jenc = jb.Encoder(stages=jparse(enc_arch), widths=widths, bottleneck=4, input_channels=1)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = jenc.apply({"params": params}, jnp.asarray(x))
    tenc = tb.Encoder(tparse(enc_arch), widths, 4, 1)
    load_jax_params(tenc, params)
    with torch.no_grad():
        out = tenc(nchw(x))
    assert sorted(out) == sorted(ref)
    for r in ref:
        np.testing.assert_allclose(nhwc(out[r]), np.asarray(ref[r]), atol=1e-5)


@pytest.mark.parametrize("h,target", [(1, 4), (4, 8), (8, 8)])
def test_upsample_nearest_matches_jax(h, target):
    x = np.random.default_rng(3).normal(0, 1, (2, h, h, 3)).astype(np.float32)
    ref = np.asarray(jb.upsample_nearest(jnp.asarray(x), target))
    np.testing.assert_array_equal(nhwc(tb.upsample_nearest(nchw(x), target)), ref)


def test_init_matches_flax_statistics():
    """``init_params`` draws as flax does: truncated lecun-normal kernels with
    unit fan-in variance, zero biases, the last conv scaled."""
    block = tb.Block(64, 64, 64, 3, last_scale=0.5)
    tb.init_params(block, torch.Generator().manual_seed(0))
    w = block.Conv_1.weight
    assert abs(w.std().item() * np.sqrt(64 * 9) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(64 * 9) + 1e-6
    last = block.Conv_3.weight
    assert abs(last.std().item() * np.sqrt(64) - 0.5) < 0.05
    assert all(torch.count_nonzero(c.bias) == 0 for c in block._convs)
    zero = tb.Block(8, 8, 8, 3, last_scale=0.0)
    tb.init_params(zero, torch.Generator().manual_seed(0))
    assert torch.count_nonzero(zero.Conv_3.weight) == 0
