"""K1 (``fused_sample_kl``) and the distribution math of the port against the
JAX package and the reference goldens.

On the CPU the port's wrapper runs the kernel's plain version; the JAX kernel
runs through the TPU interpreter, as tests/test_pallas.py runs it. The
interpreter's in-kernel PRNG gives a constant eps, so eps is recovered from
the JAX sample and fed to the port. The backward's plain version is held
against the JAX VJP ``_fskl_bwd``, which is pure jnp. test_torch_sample_kl_gpu.py
holds the CUDA kernels against the plain versions on the card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from causal_gen_tpu_torch.models.likelihoods import DGaussNet
from causal_gen_tpu_torch.ops.distributions import discretized_gaussian_nll, gaussian_kl
from causal_gen_tpu_torch.ops.sample_kl import (
    fused_sample_kl,
    fused_sample_kl_bwd,
    fused_sample_kl_bwd_ref,
    fused_sample_kl_ref,
)

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, s, shape).astype(np.float32) for s in (1.0, 0.3, 1.0, 0.3)]


@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (7, 33)])
def test_ref_matches_jax_kernel(shape):
    from causal_gen_tpu.ops.pallas_kernels import fused_sample_kl as jax_fused

    ql, qs, pl, ps = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        z_j, kl_j = jax_fused(jnp.int32(3), *(jnp.asarray(a) for a in (ql, qs, pl, ps)))
    z_j, kl_j = np.asarray(z_j), np.asarray(kl_j)
    eps = (z_j - ql) / np.exp(qs)
    z, kl = fused_sample_kl_ref(*(torch.from_numpy(a) for a in (ql, qs, pl, ps, eps)))
    np.testing.assert_allclose(z.numpy(), z_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(kl.numpy(), kl_j, rtol=1e-6, atol=1e-6)


def test_cpu_wrapper_is_the_plain_version():
    args = [torch.from_numpy(a) for a in _inputs((2, 16, 4, 4), seed=1)]
    eps = torch.randn(2, 16, 4, 4, generator=torch.Generator().manual_seed(0))
    z, kl = fused_sample_kl(*args, eps=eps)
    z_r, kl_r = fused_sample_kl_ref(*args, eps)
    assert torch.equal(z, z_r) and torch.equal(kl, kl_r)
    np.testing.assert_allclose(kl.numpy(), gaussian_kl(*args).numpy(), rtol=1e-6, atol=1e-6)
    # without eps the draw comes from the generator: same seed, same sample
    z1, _ = fused_sample_kl(*args, generator=torch.Generator().manual_seed(5))
    z2, _ = fused_sample_kl(*args, generator=torch.Generator().manual_seed(5))
    z3, _ = fused_sample_kl(*args, generator=torch.Generator().manual_seed(6))
    assert torch.equal(z1, z2) and not torch.equal(z1, z3)


def test_gaussian_kl_golden():
    g = np.load(os.path.join(GOLD, "gaussian_kl.npz"))
    names = ("q_loc", "q_logscale", "p_loc", "p_logscale")
    kl = gaussian_kl(*(torch.from_numpy(g[k]) for k in names))
    np.testing.assert_allclose(kl.numpy(), g["kl"], rtol=1e-5, atol=1e-6)


def _golden_head(g, input_channels, names):
    net = DGaussNet(input_channels, width=g["h"].shape[1])
    with torch.no_grad():
        net.x_loc.weight.copy_(torch.from_numpy(g[names[0]]))
        net.x_loc.bias.copy_(torch.from_numpy(g[names[1]]))
        net.x_logscale_kernel.copy_(torch.from_numpy(g[names[2]][:, :, 0, 0].T.copy()))
        net.x_logscale_bias.copy_(torch.from_numpy(g[names[3]]))
        if input_channels == 3:
            net.channel_coeffs.weight.copy_(torch.from_numpy(g["channel_coeffs__weight"]))
            net.channel_coeffs.bias.copy_(torch.from_numpy(g["channel_coeffs__bias"]))
    return net


def test_dgauss_nll_golden():
    """The goldens are the reference's own NCHW tensors: no permute here."""
    g = np.load(os.path.join(GOLD, "dgauss_nll.npz"))
    net = _golden_head(g, 1, ("w_loc", "b_loc", "w_ls", "b_ls"))
    h, x = torch.from_numpy(g["h"]), torch.from_numpy(g["x"])
    with torch.no_grad():
        loc, logscale = net(h, x)
        nll = net.nll(h, x)
    np.testing.assert_allclose(loc.numpy(), g["loc"], rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(logscale.numpy(), g["logscale"], rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(nll.numpy(), g["nll"], rtol=3e-5, atol=1e-6)
    direct = discretized_gaussian_nll(torch.from_numpy(g["loc"]),
                                      torch.from_numpy(g["logscale"]), x)
    np.testing.assert_allclose(direct.numpy(), g["nll"], rtol=3e-5, atol=1e-6)


def test_dgauss_rgb_golden():
    g = np.load(os.path.join(GOLD, "dgauss_rgb.npz"))
    net = _golden_head(g, 3, ("x_loc__weight", "x_loc__bias", "x_logscale__weight",
                              "x_logscale__bias"))
    h, x = torch.from_numpy(g["h"]), torch.from_numpy(g["x"])
    with torch.no_grad():
        nll = net.nll(h, x)
        loc_inf, _ = net(h)
    np.testing.assert_allclose(nll.numpy(), g["nll"], rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(loc_inf.numpy(), g["loc_inf"], rtol=3e-5, atol=1e-5)


@pytest.mark.parametrize("x_edge", [-1.0, 1.0])
def test_dgauss_nll_edges_and_floors(x_edge):
    """The +-0.999 edge branches and the 1e-12 floors, against the JAX function.

    Row 0 sits on the edge; rows 1-2 put the bin far from a narrow Gaussian, so
    the bin mass is 0 in float32 and the floor decides the value. The rest are
    ordinary pixels. Pixels where the mass is a partial cancellation of two
    CDFs near 1 are left out: there the float32 result hangs on the last ulp of
    tanh, which differs between any two libraries.
    """
    from causal_gen_tpu.ops.distributions import discretized_gaussian_nll as jax_nll

    rng = np.random.default_rng(2)
    x = rng.uniform(-0.9, 0.9, (2, 1, 6, 6)).astype(np.float32)
    loc = (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)
    logscale = rng.uniform(-3, 0, x.shape).astype(np.float32)
    x[:, :, 0, :] = x_edge
    loc[:, :, 1:3, :] = x[:, :, 1:3, :] + np.where(rng.random((2, 1, 2, 6)) < 0.5, -1.5, 1.5)
    logscale[:, :, 1:3, :] = -9.0
    loc[:, :, 0, :3] = -x_edge  # edge pixel far on the wrong side: floor again
    logscale[:, :, 0, :3] = -9.0
    ours = discretized_gaussian_nll(*(torch.from_numpy(a) for a in (loc, logscale, x)))
    ref = jax_nll(*(jnp.asarray(a) for a in (loc, logscale, x)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)
    assert np.all(ours.numpy() > 27.631 * 15 / 36)  # 15 floored pixels of 36


def test_dgauss_nll_tail_follows_tanh_ulps():
    """Known mismatch, from the JAX side (ROADMAP Queue 3): where a pixel lies
    in the far tail of a narrow Gaussian, cdf_plus - cdf_min is a difference of
    two float32 numbers near 1 and carries a few ulp. XLA's CPU tanh is off by
    several ulp there and PyTorch's by at most one, so the per-pixel NLLs
    differ by up to several nats on those pixels, and the port's is the one
    nearer the float64 value of the same formula. Elsewhere they agree."""
    import math

    from causal_gen_tpu.ops.distributions import discretized_gaussian_nll as jax_nll

    rng = np.random.default_rng(0)
    n = 20000
    x = rng.uniform(-0.99, 0.99, (n, 1)).astype(np.float32)
    loc = rng.normal(0, 0.3, (n, 1)).astype(np.float32)
    logscale = rng.uniform(-1.5, 2, (n, 1)).astype(np.float32)
    ours = discretized_gaussian_nll(*(torch.from_numpy(a) for a in (loc, logscale, x))).numpy()
    theirs = np.asarray(jax_nll(*(jnp.asarray(a) for a in (loc, logscale, x))))
    x64, l64, s64 = (a[:, 0].astype(np.float64) for a in (x, loc, logscale))

    def cdf(v):
        return 0.5 * (1 + np.tanh(math.sqrt(2 / math.pi) * (v + 0.044715 * v**3)))

    inv = np.exp(-s64)
    exact = -np.log(np.clip(cdf(inv * (x64 - l64 + 1 / 255)) - cdf(inv * (x64 - l64 - 1 / 255)),
                            1e-12, None))
    apart = np.abs(ours - theirs) > 1e-3
    assert 0 < apart.mean() < 0.05  # a tail effect, present but rare
    np.testing.assert_allclose(ours[~apart], theirs[~apart], rtol=1e-4, atol=1e-4)
    assert np.abs(ours - exact)[apart].mean() < np.abs(theirs - exact)[apart].mean()
    v = np.linspace(1.0, 9.0, 100001, dtype=np.float32)
    ulp = np.spacing(np.float32(1.0))
    jax_err = np.abs(np.asarray(jnp.tanh(jnp.asarray(v))) - np.tanh(v.astype(np.float64))).max()
    torch_err = np.abs(torch.tanh(torch.from_numpy(v)).numpy() - np.tanh(v.astype(np.float64))).max()
    assert torch_err <= ulp < 2 * ulp < jax_err


@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (7, 33)])
def test_bwd_ref_matches_jax_vjp(shape):
    """The backward's plain version against ``_fskl_bwd`` (pure jnp), called
    directly on the same residuals and cotangents."""
    from causal_gen_tpu.ops.pallas_kernels import _fskl_bwd

    ql, qs, pl, ps = _inputs(shape, seed=4)
    rng = np.random.default_rng(5)
    z, gz, gkl = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(3))
    ref = _fskl_bwd(False, tuple(jnp.asarray(a) for a in (ql, qs, pl, ps, z)),
                    (jnp.asarray(gz), jnp.asarray(gkl)))[1:]
    got = fused_sample_kl_bwd_ref(*(torch.from_numpy(a) for a in (ql, qs, pl, ps, z, gz, gkl)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_cpu_bwd_wrapper_and_autograd():
    """On the CPU, ``fused_sample_kl_bwd`` is the plain version (a missing
    cotangent counts as zero), and it agrees with autograd through the
    forward's plain version, the spatial KL sum's broadcast cotangent
    included."""
    args = [torch.from_numpy(a).requires_grad_() for a in _inputs((2, 16, 4, 4), seed=6)]
    eps = torch.randn(2, 16, 4, 4, generator=torch.Generator().manual_seed(1))
    w = torch.randn(2, 16, 4, 4, generator=torch.Generator().manual_seed(2))
    v = torch.randn(2, 16, generator=torch.Generator().manual_seed(3))
    z, kl = fused_sample_kl(*args, eps=eps)
    auto = torch.autograd.grad((z * w).sum() + (kl.sum(dim=(2, 3)) * v).sum(), args)
    gkl = v[:, :, None, None].expand(2, 16, 4, 4)
    detached = [a.detach() for a in args]
    got = fused_sample_kl_bwd(*detached, z.detach(), w, gkl)
    for g, r in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-6)
    for g, r in zip(got, fused_sample_kl_bwd_ref(*detached, z.detach(), w, gkl.contiguous())):
        assert torch.equal(g, r)
    only_kl = fused_sample_kl_bwd(*detached, z.detach(), None, gkl)
    zero = torch.zeros(())
    for g, r in zip(only_kl, fused_sample_kl_bwd_ref(*detached, z.detach(), zero, gkl)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (2, 3, 4, 5, 6), (2, 3, 1, 1, 1)])
def test_per_row_reads_a_kl_cotangent_summed_over_space(shape):
    """The KL is summed over every spatial axis (two for images, three for
    volumes), so autograd hands K1-bwd a cotangent that is a stride-0
    broadcast over those axes: ``_per_row`` gives its (B, C) values and the
    repeat; a materialised map comes back as it is, repeat 1."""
    from causal_gen_tpu_torch.ops.sample_kl import _per_row

    kl = torch.zeros(shape, requires_grad=True)
    v = torch.randn(shape[:2], generator=torch.Generator().manual_seed(0))
    (g,) = torch.autograd.grad((kl.sum(dim=tuple(range(2, len(shape)))) * v).sum(), kl)
    vals, rep = _per_row(g)
    n = int(np.prod(shape[2:]))
    if n > 1:
        assert g.stride()[2:] == (0,) * (len(shape) - 2)
        assert rep == n and torch.equal(vals, v)
    assert torch.equal(vals.repeat_interleave(rep, dim=1).reshape(shape), g)
    dense = g.contiguous()
    vals_d, rep_d = _per_row(dense)
    assert rep_d == 1 and torch.equal(vals_d, dense)
