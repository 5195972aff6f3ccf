"""Sampling at a temperature: the port's DMoL sampler (K4's plain version),
mean decode and heads against the JAX package, on the CPU.

- ``sample_from_discretized_mix_logistic`` against the JAX function given the
  same uniforms (rebuilt from its key): the same mixture on every pixel, x and
  scale within 1e-5 abs + 1e-5 rel.
- The same plain version against the Pallas kernel ``dmol_sample_pallas`` run
  in interpret mode, whose generator returns zero bits there
  (tests/test_pallas.py), so that every uniform is 1e-5: 1e-5 abs + rel.
- ``mean_discretized_mix_logistic`` for each mask, a tie at the k-th logit
  included, and both heads' ``sample`` in both modes, with converted
  parameters and the JAX heads' draws injected: 1e-5 abs + rel.
- ``sample_gaussian`` on the CPU draws ``torch.randn`` from the generator it
  is given, or from the default one; a CUDA tensor with a CPU generator is
  tested on the card (test_torch_dmol_sample_gpu.py).

test_torch_dmol_sample_gpu.py holds the CUDA kernel against the plain version
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.ops import dmol as jdmol
from causal_gen_tpu_torch.config import get_config
from causal_gen_tpu_torch.models.hvae import HVAE
from causal_gen_tpu_torch.models.likelihoods import DGaussNet, DmolNet
from causal_gen_tpu_torch.ops.distributions import sample_gaussian
from causal_gen_tpu_torch.ops.dmol import (
    UNIFORM_HI,
    UNIFORM_LO,
    gumbel_select,
    mean_discretized_mix_logistic,
    sample_from_discretized_mix_logistic,
    uniforms,
)
from causal_gen_tpu_torch.ops.dmol_sample import dmol_sample

from tests.torch_parity import (
    jax_dmol_uniforms,
    load_jax_params,
    nchw,
    nhwc,
    patch_jax_head_draws,
)

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def dmol_params(b, h, w, seed, k=10):
    """NHWC l (b,h,w,10k): logits ~ N(0, 1), means ~ N(0, 0.5), log-scales
    uniform on [-7.5, 0.5] (some below the -7 floor), coeffs ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    l = rng.normal(0, 1, (b, h, w, 10 * k))
    for c in range(3):
        base = k + 3 * k * c
        l[..., base: base + k] = rng.normal(0, 0.5, (b, h, w, k))
        l[..., base + k: base + 2 * k] = rng.uniform(-7.5, 0.5, (b, h, w, k))
    return l.astype(np.float32)


@pytest.mark.parametrize("t", [None, 0.3, 1.0])
def test_sampler_matches_jax_given_its_uniforms(t):
    b, h, w = 3, 6, 5
    l = dmol_params(b, h, w, seed=1)
    key = jax.random.PRNGKey(7)
    jx, js = jdmol.sample_from_discretized_mix_logistic(key, jnp.asarray(l), 10, t=t)
    u_mix, u = jax_dmol_uniforms(key, b, h, w)
    lt = nchw(l)
    x, s = sample_from_discretized_mix_logistic(lt, 10, t, u_mix=u_mix, u=u)
    k_mix = jax.random.split(key)[0]
    eps = jax.random.uniform(k_mix, (b, h, w, 10), minval=1e-5, maxval=1.0 - 1e-5)
    jpick = jnp.argmax(jnp.asarray(l)[..., :10] - jnp.log(-jnp.log(eps)), axis=-1)
    np.testing.assert_array_equal(gumbel_select(lt, u_mix, 10).numpy(), np.asarray(jpick))
    np.testing.assert_allclose(nhwc(x), np.asarray(jx), **TOL)
    np.testing.assert_allclose(nhwc(s), np.asarray(js), **TOL)
    # the CPU wrapper of K4 is this plain version
    xw, sw = dmol_sample(lt, 10, t=1.0 if t is None else t, u_mix=u_mix, u=u)
    assert torch.equal(xw, x) and torch.equal(sw, s)


@pytest.mark.parametrize("t", [1e-6, 0.5, 1.0])
def test_plain_sampler_matches_pallas_interpret(t):
    """The Pallas kernel in interpret mode draws zero bits, so each of its
    uniforms is float32(1e-5): the pick is the first argmax of the logits and
    y_c = mean + scale (log 1e-5 - log(1 - 1e-5)); the kernel's -7 floor,
    temperature and clip chain all show in the output."""
    from jax.experimental.pallas import tpu as pltpu

    from causal_gen_tpu.ops.pallas_kernels import dmol_sample_pallas

    rng = np.random.default_rng(4)
    l = rng.normal(0, 1.5, (2, 5, 7, 100)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jx, js = dmol_sample_pallas(jnp.int32(9), jnp.asarray(l), 10, t=t)
    u_mix = torch.full((2, 10, 5, 7), UNIFORM_LO)
    u = torch.full((2, 3, 5, 7), UNIFORM_LO)
    x, s = sample_from_discretized_mix_logistic(nchw(l), 10, t, u_mix=u_mix, u=u)
    np.testing.assert_allclose(nhwc(x), np.asarray(jx), **TOL)
    np.testing.assert_allclose(nhwc(s), np.asarray(js), **TOL)
    # the clip binds on some pixels and not on others
    assert (x.abs() == 1).any() and (x.abs() < 1).any()


def test_sampler_draws_from_the_generator():
    l = nchw(dmol_params(2, 4, 4, seed=2))
    a = sample_from_discretized_mix_logistic(l, 10, 0.5, generator=torch.Generator().manual_seed(3))
    b = sample_from_discretized_mix_logistic(l, 10, 0.5, generator=torch.Generator().manual_seed(3))
    c = sample_from_discretized_mix_logistic(l, 10, 0.5, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    u = uniforms((1 << 16,), torch.Generator().manual_seed(0), torch.device("cpu"))
    assert u.min() >= UNIFORM_LO and u.max() < UNIFORM_HI
    with pytest.raises(ValueError, match="together"):
        dmol_sample(l, 10, u_mix=torch.rand(2, 10, 4, 4))


def _tied_logits(l):
    """Ties the 4th largest logit of every pixel to the 3rd."""
    logits = l[..., :10]
    order = np.argsort(-logits, axis=-1)
    third = np.take_along_axis(logits, order[..., 2:3], axis=-1)
    np.put_along_axis(logits, order[..., 3:4], third, axis=-1)
    return l


@pytest.mark.parametrize("mask", ["soft", "hard", "top3", "top3-tie"])
def test_mean_decode_matches_jax(mask):
    l = dmol_params(2, 5, 6, seed=3)
    if mask == "top3-tie":
        l = _tied_logits(l)
        mask = "top3"
        kept = (l[..., :10] >= np.sort(l[..., :10], axis=-1)[..., -3:-2]).sum(-1)
        assert (kept == 4).all()  # a top-k of exactly 3 would differ here
    jx, js = jdmol.mean_discretized_mix_logistic(jnp.asarray(l), 10, mask=mask)
    x, s = mean_discretized_mix_logistic(nchw(l), 10, mask=mask)
    np.testing.assert_allclose(nhwc(x), np.asarray(jx), **TOL)
    np.testing.assert_allclose(nhwc(s), np.asarray(js), **TOL)


def test_mean_decode_refuses_a_bad_mask():
    with pytest.raises(ValueError):
        mean_discretized_mix_logistic(nchw(dmol_params(1, 2, 2, seed=0, k=5)), 5, mask="top5")
    l = nchw(dmol_params(1, 2, 2, seed=0))
    with pytest.raises(NotImplementedError):
        mean_discretized_mix_logistic(l, 10, mask="median")


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("t", [None, 0.5])
@pytest.mark.parametrize("return_loc", [True, False])
def test_dgauss_head_sample_matches_jax(monkeypatch, channels, t, return_loc):
    from causal_gen_tpu.models.likelihoods import DGaussNet as JDGaussNet

    rng = np.random.default_rng(channels)
    h = rng.normal(0, 1, (2, 6, 6, 16)).astype(np.float32)
    jhead = JDGaussNet(input_channels=channels, width=16)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(h))["params"]
    rec = patch_jax_head_draws(monkeypatch, seed=5)
    jx, js = jhead.apply({"params": params}, jnp.asarray(h), return_loc, t,
                         method=jhead.sample, rngs={"sample": jax.random.PRNGKey(1)})
    assert len(rec.draws) == (0 if return_loc else 1)
    head = DGaussNet(channels, 16)
    load_jax_params(head, params)
    with torch.no_grad():
        x, s = head.sample(nchw(h), return_loc, t, noise=rec.draws[0] if rec.draws else None)
        s_none = head.sample(nchw(h), return_loc, None, noise=rec.draws[0] if rec.draws else None)[1]
    np.testing.assert_allclose(nhwc(x), np.asarray(jx), **TOL)
    np.testing.assert_allclose(nhwc(s), np.asarray(js), **TOL)
    if return_loc:  # the JAX head applies no temperature to its loc mode
        assert torch.equal(s, s_none)
    elif t is not None:
        np.testing.assert_allclose(s.numpy(), s_none.numpy() * t, rtol=1e-6)


@pytest.mark.parametrize("return_loc", [True, False])
def test_dmol_head_sample_matches_jax(monkeypatch, return_loc):
    from causal_gen_tpu.models.likelihoods import DmolNet as JDmolNet

    rng = np.random.default_rng(6)
    h = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    jhead = JDmolNet(input_channels=3, width=16)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(h))["params"]
    rec = patch_jax_head_draws(monkeypatch, seed=6)
    jx, js = jhead.apply({"params": params}, jnp.asarray(h), return_loc, 0.6,
                         method=jhead.sample, rngs={"sample": jax.random.PRNGKey(2)})
    head = DmolNet(3, 16)
    load_jax_params(head, params)
    with torch.no_grad():
        x, s = head.sample(nchw(h), return_loc, 0.6,
                           uniforms=None if return_loc else rec.draws[0])
    assert len(rec.draws) == (0 if return_loc else 1)
    np.testing.assert_allclose(nhwc(x), np.asarray(jx), **TOL)
    np.testing.assert_allclose(nhwc(s), np.asarray(js), **TOL)


def test_sample_gaussian_with_a_cpu_generator_draws_as_before():
    loc = torch.linspace(-1, 1, 60).reshape(2, 3, 10)
    logscale = torch.linspace(-2, 0.5, 60).reshape(2, 3, 10)
    got = sample_gaussian(loc, logscale, generator=torch.Generator().manual_seed(3))
    eps = torch.randn(loc.shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, loc + torch.exp(logscale) * eps)
    # and without a generator, from the default one on the tensor's device
    torch.manual_seed(5)
    got = sample_gaussian(loc, logscale)
    torch.manual_seed(5)
    assert torch.equal(got, loc + torch.exp(logscale) * torch.randn(loc.shape))


def test_full_width_cmnist_dmol_sample_on_cpu():
    """The port alone at the registry's Colour-MNIST widths with the DMoL
    head, bs 2: a sample at t = 0.7 and the mean decode."""
    g = torch.Generator().manual_seed(0)
    cfg = get_config("cmnist", bs=2, x_like="diag_dmol")
    vae = HVAE(cfg, device="cpu", generator=g)
    pa = torch.cat([torch.eye(10)[[3, 7]], torch.eye(10)[[1, 4]]], dim=1)
    with torch.no_grad():
        x, s = vae.sample(pa, return_loc=False, t=0.7, generator=g)
        loc, s_loc = vae.sample(pa, return_loc=True, t=0.7, generator=g)
    for a in (x, s, loc, s_loc):
        assert a.shape == (2, 3, 32, 32) and torch.isfinite(a).all()
    assert x.abs().max() <= 1 and loc.abs().max() <= 1 and (s > 0).all()
