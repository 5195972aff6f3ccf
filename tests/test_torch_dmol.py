"""K3's plain versions and the DMoL head of the port against the JAX package.

- The plain loss (``ops/dmol.py``) against ``causal_gen_tpu.ops.dmol`` and
  its goldens (1e-5 abs per image), and against the Pallas kernel run in
  interpret mode, as tests/test_pallas.py runs it (1e-5 abs + 1e-5 rel per
  pixel, on log-scales ~ N(0, 1) as there).
- Its gradient in l, by autograd and by the backward kernel's closed form
  (``dmol_loss_bwd_ref``), against ``jax.grad``: 1e-5 abs + 1e-4 rel. Where a
  narrow red scale makes a gradient element ~1, XLA and PyTorch differ there
  by ~1e-5 rel. The closed form against autograd: 1e-6 abs + 1e-5 rel.
- Train steps of the small Colour-MNIST HVAE with the diag_dmol head, as
  test_torch_train.py runs the dgauss head.
- The kernels' launch plan (``ops/dmol_loss.py::plan``): tiles, threads,
  shared memory and tiles that straddle two images.

test_torch_dmol_gpu.py holds the CUDA kernels against these plain versions
on the card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.ops.dmol import discretized_mix_logistic_loss as jloss
from causal_gen_tpu_torch.models.likelihoods import DmolNet, make_likelihood
from causal_gen_tpu_torch.ops.distributions import log_prob_from_logits
from causal_gen_tpu_torch.ops.dmol import discretized_mix_logistic_loss, dmol_logprob_pixels
from causal_gen_tpu_torch.ops.dmol_loss import (
    MIXTURES,
    dmol_logprob,
    dmol_loss,
    dmol_loss_bwd,
    dmol_loss_bwd_ref,
    plan,
)

from chip_smoke import k3_inputs
from tests.torch_parity import assert_states_match, load_jax_params, run_steps_against_jax

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def edge_inputs(b, h, w, seed=0, narrow=False):
    """NHWC numpy copies of chip_smoke.k3_inputs: x on the 8-bit grid with
    rows at -1 and 1; with ``narrow``, log-scales down past the -7 floor and
    a column of pixels on both sides of the 1e-5 switch, where cdf_delta is
    a difference of two sigmoids near 1 and the last ulps of each count."""
    x, l = k3_inputs(b, h, w, "cpu", seed=seed, narrow=narrow)
    return (np.ascontiguousarray(x.permute(0, 2, 3, 1).numpy()),
            np.ascontiguousarray(l.permute(0, 2, 3, 1).numpy()))


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_log_prob_from_logits_matches_jax():
    from causal_gen_tpu.ops.distributions import log_prob_from_logits as jlp

    a = np.random.default_rng(0).normal(0, 3, (4, 5, 10)).astype(np.float32)
    np.testing.assert_allclose(log_prob_from_logits(torch.from_numpy(a)).numpy(),
                               np.asarray(jlp(jnp.asarray(a))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("low_bit", [False, True])
def test_plain_loss_matches_goldens(low_bit):
    g = np.load(os.path.join(GOLD, "dmol.npz"))
    loss = discretized_mix_logistic_loss(to_nchw(g["x"]), to_nchw(g["l"]), low_bit=low_bit)
    np.testing.assert_allclose(loss.numpy(), g["loss_low_bit" if low_bit else "loss"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,narrow", [((2, 6, 6), False), ((3, 8, 5), True)])
def test_plain_loss_and_gradient_match_jax(shape, narrow):
    x, l = edge_inputs(*shape, narrow=narrow)
    b = shape[0]
    w = np.arange(1, b + 1, dtype=np.float32)  # a different cotangent per image
    jl = jloss(jnp.asarray(x), jnp.asarray(l))
    jg = jax.grad(lambda ll: jnp.sum(jloss(jnp.asarray(x), ll) * w))(jnp.asarray(l))
    jg = np.asarray(jg).transpose(0, 3, 1, 2)
    tx, tl = to_nchw(x), to_nchw(l).requires_grad_()
    out = discretized_mix_logistic_loss(tx, tl)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tl.grad.numpy(), jg, rtol=1e-4, atol=1e-5)
    twin = dmol_loss_bwd_ref(tx, tl.detach(), torch.from_numpy(w))
    np.testing.assert_allclose(twin.numpy(), jg, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("low_bit", [False, True])
@pytest.mark.parametrize("shape", [(2, 6, 6), (3, 8, 5)])
def test_closed_form_backward_matches_autograd(shape, low_bit):
    """The backward kernel's math against autograd of the plain op, on inputs
    that reach every branch, the -7 floor and both sides of the switch."""
    x, l = edge_inputs(*shape, narrow=True)
    w = torch.arange(1, shape[0] + 1, dtype=torch.float32)
    tx, tl = to_nchw(x), to_nchw(l).requires_grad_()
    (discretized_mix_logistic_loss(tx, tl, low_bit) * w).sum().backward()
    twin = dmol_loss_bwd_ref(tx, tl.detach(), w, low_bit)
    np.testing.assert_allclose(twin.numpy(), tl.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_edge_inputs_reach_every_branch():
    """The narrow inputs select each branch of the where chain, and put
    pixels on both sides of the 1e-5 switch."""
    x, l = edge_inputs(2, 6, 6, narrow=True)
    tx, tl = to_nchw(x), to_nchw(l)
    ls = torch.clamp(tl[:, 20:30], min=-7.0)  # red log-scales
    u = tx[:, :1] - tl[:, 10:20]
    inv = torch.exp(-ls)
    delta = torch.sigmoid(inv * (u + 1 / 255)) - torch.sigmoid(inv * (u - 1 / 255))
    inner = (tx[:, :1] > -0.999) & (tx[:, :1] < 0.999)
    assert (tx == -1).any() and (tx == 1).any()
    assert ((delta > 1e-5) & inner).any() and ((delta <= 1e-5) & inner).any()
    switch = delta[:, :, 2:, 0]
    assert (switch > 1e-5).any() and (switch <= 1e-5).any()


@pytest.mark.parametrize("low_bit", [False, True])
def test_plain_per_pixel_matches_pallas_interpret(low_bit):
    """1e-5 abs + 1e-5 rel per pixel; low_bit takes the kernels' other
    constants (a half bin of 1/31, the tail's log 15.5)."""
    from jax.experimental.pallas import tpu as pltpu

    from causal_gen_tpu.ops.pallas_kernels import _dmol_logprob_pixels

    x, l = edge_inputs(2, 6, 6, seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = _dmol_logprob_pixels(jnp.asarray(x), jnp.asarray(l), low_bit, False)
    got = dmol_logprob_pixels(to_nchw(x), to_nchw(l), low_bit)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(32, 32, 32), (3, 7, 13), (1, 1, 1), (256, 32, 32)])
def test_launch_plan(shape, backward):
    """Every pixel in exactly one tile, at most 1024 threads a block, shared
    memory under the 48 KB that needs no opt-in, and a tile that holds the
    end of one image and the start of the next planned as straddling."""
    b, h, w = shape
    n, hw = b * h * w, h * w
    pl = plan(n, hw, backward=backward)
    assert pl.tile in (32, 64) and pl.threads == MIXTURES * pl.tile <= 1024
    tiles = [range(t * pl.tile, min((t + 1) * pl.tile, n)) for t in range(pl.blocks)]
    owner = np.zeros(n, int)
    for t in tiles:
        owner[list(t)] += 1
    assert (owner == 1).all() and all(len(t) for t in tiles)
    assert pl.shared_bytes == (2 * MIXTURES + 2) * pl.tile * 4 <= 48 * 1024
    straddling = [t for t in tiles if t[0] // hw != t[-1] // hw]
    assert pl.straddles == bool(straddling)
    assert pl.straddles == (shape == (3, 7, 13))


def test_launch_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        plan(10, 3)  # not whole images
    with pytest.raises(ValueError):
        plan(2 ** 31, 2 ** 10)
    assert plan(0, 0).blocks == 0


def test_cpu_wrappers_are_the_plain_versions():
    x, l = edge_inputs(2, 5, 4, seed=2)
    tx, tl = to_nchw(x), to_nchw(l)
    g = torch.tensor([0.5, -2.0])
    assert torch.equal(dmol_logprob(tx, tl), dmol_logprob_pixels(tx, tl))
    assert torch.equal(dmol_loss(tx, tl), discretized_mix_logistic_loss(tx, tl))
    assert torch.equal(dmol_loss_bwd(tx, tl, g), dmol_loss_bwd_ref(tx, tl, g))


def test_dmol_head_matches_jax():
    from causal_gen_tpu.models.likelihoods import DmolNet as JDmolNet

    rng = np.random.default_rng(3)
    h = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    x = ((rng.integers(0, 256, (2, 8, 8, 3)) - 127.5) / 127.5).astype(np.float32)
    jhead = JDmolNet(input_channels=3, width=16)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(h))["params"]
    ref = jhead.apply({"params": params}, jnp.asarray(h), jnp.asarray(x), method=jhead.nll)
    head = make_likelihood(3, 16, "diag_dmol", 0.0)
    assert isinstance(head, DmolNet)
    load_jax_params(head, params)
    got = head.nll(to_nchw(h), to_nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # the head's sample modes are held against JAX in test_torch_sample.py;
    # here its default, the soft mean decode
    jx, js = jhead.apply({"params": params}, jnp.asarray(h), method=jhead.sample)
    x, s = head.sample(to_nchw(h))
    np.testing.assert_allclose(x.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.detach().permute(0, 2, 3, 1).numpy(), np.asarray(js),
                               rtol=1e-5, atol=1e-5)


def _cmnist_cfg(jax_side, **overrides):
    if jax_side:
        from causal_gen_tpu.config import get_config
    else:
        from causal_gen_tpu_torch.config import get_config
    return get_config("cmnist", bs=8, input_res=16, x_like="diag_dmol",
                      enc_arch="16b1d2,8b1d2,4b1d4,1b1", dec_arch="1b1,4b1,8b1,16b1",
                      widths=(8, 8, 16, 16), z_dim=4, bias_max_res=16, **overrides)


def test_train_steps_match_jax_dmol(monkeypatch):
    """Three updates and one skipped step (a NaN parent) at accu_steps 2, with
    beta and lr warmup running, on the diag_dmol head: 1e-4 rel on the
    metrics, 1e-5 abs on every parameter and EMA element."""
    over = dict(accu_steps=2, beta_warmup_steps=3, lr_warmup_steps=2)
    metrics, jstate, tstate = run_steps_against_jax(
        _cmnist_cfg(True, **over), _cmnist_cfg(False, **over), 3, 20, monkeypatch)
    assert [tm["skipped"] for _, tm in metrics] == [0.0, 0.0, 1.0, 0.0]
    assert_states_match(metrics, jstate, tstate)
