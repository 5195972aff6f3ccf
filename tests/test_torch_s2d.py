"""The port's space-to-depth conv (causal_gen_tpu_torch/ops/s2d.py, NCHW and
OIHW) against the JAX package's (causal_gen_tpu/ops/s2d.py, NHWC and HWIO)
on the same inputs: the packing and its inverse (the same packed channel
order, not merely some bijection), both kernel packings, s2d_conv with and
without bias, packed in and out, and the gradients of the compact kernel,
the bias and the input.

Tolerances: the layouts and packed kernels exactly; float32 convs 1e-5 abs +
rel (the packed conv sums in another order and adds zero taps); against
F.conv2d in float64 exact on integer-valued inputs (every sum exact) and
1e-12 on normal ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from causal_gen_tpu.ops import s2d as js2d
from causal_gen_tpu_torch.ops import s2d

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def inputs(b, c, co, h, k, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, c)).astype(dtype)  # NHWC
    w = rng.standard_normal((k, k, c, co)).astype(dtype)  # HWIO
    bias = rng.standard_normal(co).astype(dtype)
    return x, w, bias


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (1, 5, 6, 10)])
def test_pack_and_unpack_match_jax(shape):
    b, c, h, w = shape
    x = np.random.default_rng(1).standard_normal((b, h, w, c)).astype(np.float32)
    got = s2d.pack_space_to_depth(nchw(x))
    ref = js2d.pack_space_to_depth(jnp.asarray(x))
    assert got.shape == (b, 4 * c, h // 2, w // 2)
    assert torch.equal(got, nchw(ref))
    assert torch.equal(s2d.unpack_depth_to_space(got), nchw(x))
    assert torch.equal(s2d.unpack_depth_to_space(got),
                       nchw(js2d.unpack_depth_to_space(ref)))


def test_pack_is_phase_major():
    # packed channel (phase*C + c), phase = 2*(y%2) + (x%2): y=1, x=0 -> phase 2
    x = torch.zeros(1, 2, 4, 4)
    x[0, 1, 1, 0] = 7.0
    p = s2d.pack_space_to_depth(x)
    assert p.shape == (1, 8, 2, 2)
    assert p[0, 2 * 2 + 1, 0, 0].item() == 7.0 and p.abs().sum().item() == 7.0


@pytest.mark.parametrize("k", [3, 1])
def test_kernel_packing_matches_jax(k):
    _, w, _ = inputs(1, 5, 4, 4, k, seed=2)
    pack, jpack = ((s2d.pack_kernel_3x3, js2d.pack_kernel_3x3) if k == 3
                   else (s2d.pack_kernel_1x1, js2d.pack_kernel_1x1))
    got = pack(oihw(w))
    assert got.shape == (16, 20, k, k)
    assert torch.equal(got, oihw(jpack(jnp.asarray(w))))
    # each tap fills one packed slot a phase: 36 of 144 (3x3) or 4 of 16 (1x1) blocks
    assert (got != 0).float().mean().item() == pytest.approx(0.25, abs=0.02)


def test_kernel_packing_refuses_other_sizes():
    with pytest.raises(ValueError):
        s2d.pack_kernel_3x3(torch.zeros(2, 2, 1, 1))
    with pytest.raises(ValueError):
        s2d.s2d_conv(torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 5, 5))


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("packed_in,packed_out", [(False, False), (True, False), (False, True),
                                                  (True, True)])
def test_s2d_conv_matches_jax(k, bias, packed_in, packed_out):
    x, w, b = inputs(2, 6, 5, 8, k, seed=3)
    jx = jnp.asarray(x)
    tx = nchw(x)
    if packed_in:
        jx, tx = js2d.pack_space_to_depth(jx), s2d.pack_space_to_depth(tx)
    ref = js2d.s2d_conv(jx, jnp.asarray(w), jnp.asarray(b) if bias else None,
                        packed_in=packed_in, packed_out=packed_out)
    got = s2d.s2d_conv(tx, oihw(w), torch.from_numpy(b) if bias else None,
                       packed_in=packed_in, packed_out=packed_out)
    assert got.shape == nchw(ref).shape
    np.testing.assert_allclose(got.numpy(), nchw(ref).numpy(), **TOL)


@pytest.mark.parametrize("k", [3, 1])
def test_gradients_match_jax(k):
    """jax.grad through the packed conv, of the compact kernel (the
    parameter), the bias and the input, against autograd."""
    x, w, b = inputs(2, 4, 3, 6, k, seed=4)
    g = np.random.default_rng(5).standard_normal((2, 6, 6, 3)).astype(np.float32)

    def jloss(x_, w_, b_):
        return jnp.sum(js2d.s2d_conv(x_, w_, b_) * jnp.asarray(g))

    jgx, jgw, jgb = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                                       jnp.asarray(b))
    tx, tw, tb = (nchw(x).requires_grad_(), oihw(w).requires_grad_(),
                  torch.from_numpy(b).requires_grad_())
    (s2d.s2d_conv(tx, tw, tb) * nchw(g)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), oihw(jgw).numpy(), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), nchw(jgx).numpy(), **TOL)


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("ci,co,h", [(3, 5, 8), (8, 32, 12), (32, 8, 6)])
def test_exact_against_conv2d_in_float64(k, ci, co, h):
    rng = np.random.default_rng(6)
    # integer-valued: every product and sum is exact, so the packed conv and
    # F.conv2d agree bit for bit whatever their summation order
    x = torch.from_numpy(rng.integers(-8, 9, (2, ci, h, h)).astype(np.float64))
    w = torch.from_numpy(rng.integers(-8, 9, (co, ci, k, k)).astype(np.float64))
    b = torch.from_numpy(rng.integers(-8, 9, co).astype(np.float64))
    assert torch.equal(s2d.s2d_conv(x, w, b), F.conv2d(x, w, b, padding=k // 2))
    assert torch.equal(s2d.s2d_conv(x, w), F.conv2d(x, w, padding=k // 2))
    x = torch.from_numpy(rng.standard_normal((2, ci, h, h)))
    w = torch.from_numpy(rng.standard_normal((co, ci, k, k)))
    torch.testing.assert_close(s2d.s2d_conv(x, w), F.conv2d(x, w, padding=k // 2),
                               rtol=1e-12, atol=1e-12)


def test_padding_edges_exact():
    # SAME padding agrees at the borders: the packed kernel's qy = -1 slots
    # reach packed row -1, phase 1, never row -2
    x = torch.ones(1, 2, 6, 6, dtype=torch.float64)
    w = torch.ones(3, 2, 3, 3, dtype=torch.float64)
    assert torch.equal(s2d.s2d_conv(x, w), F.conv2d(x, w, padding=1))
