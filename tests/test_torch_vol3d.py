"""3-D volumes (``spatial_dims=3``, the ``vol3d32`` family) in the port against
the JAX package: the Conv3d ``Block`` and ``Encoder``; the HVAE's ELBO,
``abduct``, ``forward_latents`` and ``sample`` in float32 and bf16 on a
reduced vol3d32 config (8^3, widths 8-32, light blocks, k=1 at res <= 2, a
res-4 bias); a float32 train step; the port's ``vol3d`` builder array-equal
to JAX's. Parameters from a seed (torch_parity.random_jax_params), converted
(5-D kernels and r^3 biases); the same injected draws on both sides.

Tolerances as tests/test_torch_ukbb.py states them: float32 1e-5 abs + rel
(the ELBO terms 1e-4 rel); bf16 a tensor within e = 2^-4 of its scale
max(1, max |ref|), the ELBO terms within 2e-2 rel, and a sampled voxel
x = loc + scale eps within e (1 + 2 |scale eps|) (the seeded weights make
scales up to ~6, so the scale's rounding times eps outgrows e alone). The
NLL goes through one function on both sides
(torch_parity.patch_jax_nll_with_port).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.config import get_config as jget
from causal_gen_tpu.models import blocks as jb
from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu_torch.config import get_config as tget
from causal_gen_tpu_torch.convert import params_from_jax
from causal_gen_tpu_torch.models import blocks as tb
from causal_gen_tpu_torch.models.hvae import HVAE, plan_decoder_blocks

from tests.test_torch_ukbb import BF16_SCALE_TOL, _close, _scalar_close
from tests.torch_parity import (
    assert_states_match,
    load_jax_params,
    nchw,
    nhwc,
    patch_jax_head_draws,
    patch_jax_nll_with_port,
    patch_jax_noise,
    random_jax_params,
    run_steps_against_jax,
    to_numpy,
)

torch.set_num_threads(1)

N, RES = 2, 8
ARCH = dict(input_res=RES, bs=N, enc_arch="8b1d2,4b1d4,1b1", dec_arch="1b1,4b2,8b1",
            widths=(8, 16, 32), z_dim=4, bias_max_res=4)


@pytest.mark.parametrize("version,in_w,out_w,k,down,residual", [
    ("light", 8, 8, 3, None, True),  # what K2 covers in 2-D: the Conv3d pair here
    ("light", 8, 12, 3, 2, True),  # width_proj + avg_pool3d
    (None, 8, 16, 3, 2, True),  # GELU body, width_proj + avg_pool3d
    (None, 12, 10, 1, None, False),  # 1x1x1 prior/posterior-style head
])
def test_block_3d_matches_jax(version, in_w, out_w, k, down, residual):
    x = np.random.default_rng(0).normal(0, 1, (2, 4, 4, 4, in_w)).astype(np.float32)
    jblock = jb.Block(in_width=in_w, bottleneck=4, out_width=out_w, kernel_size=k,
                      residual=residual, down_rate=down, version=version, last_scale=0.7,
                      spatial_dims=3)
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    tblock = tb.Block(in_w, 4, out_w, k, residual=residual, down_rate=down, version=version,
                      spatial_dims=3)
    assert not tblock.k2_covered  # K2 is the 2-D body
    load_jax_params(tblock, params)
    with torch.no_grad():
        out = tblock(nchw(x))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-5)


@pytest.mark.parametrize("res", [8, 7])
def test_encoder_3d_matches_jax(res):
    """The Conv3d stem and blocks; at an odd size the pad over every spatial
    axis (reference vae.py:131-132)."""
    cfg = jget("vol3d32", **dict(ARCH, input_res=res))
    x = np.random.default_rng(1).uniform(-1, 1, (2, res, res, res, 1)).astype(np.float32)
    jenc = jb.Encoder(stages=cfg.enc_stages, widths=cfg.model_widths, bottleneck=cfg.bottleneck,
                      input_channels=1, version="light", spatial_dims=3)
    params = jenc.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    ref = jenc.apply({"params": params}, jnp.asarray(x))
    tenc = tb.Encoder(cfg.enc_stages, cfg.model_widths, cfg.bottleneck, 1, "light",
                      spatial_dims=3)
    load_jax_params(tenc, params)
    with torch.no_grad():
        acts = tenc(nchw(x))
    assert sorted(acts) == sorted(ref)
    for r in acts:
        np.testing.assert_allclose(nhwc(acts[r]), np.asarray(ref[r]), atol=1e-5, err_msg=r)


@functools.cache
def _pair(dtype):
    jcfg, tcfg = jget("vol3d32", dtype=dtype, **ARCH), tget("vol3d32", dtype=dtype, **ARCH)
    jvae = JHVAE(cfg=jcfg)
    params = random_jax_params(jvae, jcfg)
    tvae = HVAE(tcfg, device="cpu")
    tvae.load_state_dict(params_from_jax(to_numpy(params)), strict=True)
    return jvae, params, tvae


def _japply(jvae, params, *args, **kw):
    return jax.jit(lambda p, *a: jvae.apply({"params": p}, *a, **kw))(params, *args)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (N, RES, RES, RES, 1)).astype(np.float32),
            rng.uniform(-1, 1, (N, 2)).astype(np.float32))


N_STOCHASTIC = 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elbo_3d_matches_jax(monkeypatch, dtype):
    bf16 = dtype == "bfloat16"
    jvae, params, tvae = _pair(dtype)
    assert not any(b.k2_covered for b in tvae.modules() if isinstance(b, tb.Block))
    assert tuple(tvae.decoder.bias_4.shape) == (1, 16, 4, 4, 4)
    x, pa = _inputs(0)
    rec = patch_jax_noise(monkeypatch, seed=11)
    patch_jax_nll_with_port(monkeypatch)
    ref = _japply(jvae, params, jnp.asarray(x), jnp.asarray(pa), beta=1.0, train=True,
                  rngs={"sample": jax.random.PRNGKey(3)})
    assert len(rec.draws) == N_STOCHASTIC
    with torch.no_grad():
        out = tvae(nchw(x), torch.from_numpy(pa), beta=1.0, noise=iter(rec.torch_noise()))
    for k in ("elbo", "nll", "kl"):
        if bf16:
            _scalar_close(out[k], ref[k], bf16, k)
        else:
            np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_abduct_forward_latents_and_sample_3d_match_jax(monkeypatch, dtype):
    bf16 = dtype == "bfloat16"
    jvae, params, tvae = _pair(dtype)
    x, pa = _inputs(1)
    cf_pa = pa.copy()
    cf_pa[:, 0] = -0.5  # do(radius)
    rec = patch_jax_noise(monkeypatch, seed=12)
    jz = _japply(jvae, params, jnp.asarray(x), jnp.asarray(pa), method=jvae.abduct,
                 rngs={"sample": jax.random.PRNGKey(4)})
    with torch.no_grad():
        tz = tvae.abduct(nchw(x), torch.from_numpy(pa), noise=iter(rec.torch_noise()))
    assert [tuple(z.shape[2:]) for z in tz] == [(r,) * 3 for r, _ in plan_decoder_blocks(
        tvae.cfg)]
    for i, (a, b) in enumerate(zip(tz, jz)):
        _close(nhwc(a), b, bf16, f"z{i}")
    for name, parents in (("factual", pa), ("do(radius)", cf_pa)):
        jloc, jscale = _japply(jvae, params, jz, jnp.asarray(parents),
                               method=jvae.forward_latents)
        with torch.no_grad():
            loc, scale = tvae.forward_latents([nchw(z) for z in jz], torch.from_numpy(parents))
        _close(nhwc(loc), jloc, bf16, f"{name} loc")
        _close(nhwc(scale), jscale, bf16, f"{name} scale")

    prior = patch_jax_noise(monkeypatch, seed=14)
    heads = patch_jax_head_draws(monkeypatch, seed=15)
    jx, js = _japply(jvae, params, jnp.asarray(pa), method=jvae.sample, return_loc=False,
                     t=0.7, rngs={"sample": jax.random.PRNGKey(7)})
    with torch.no_grad():
        sx, ss = tvae.sample(torch.from_numpy(pa), False, 0.7,
                             noise=iter(prior.torch_noise() + heads.draws))
    assert sx.shape == (N, 1, RES, RES, RES) and sx.dtype == torch.float32
    _close(nhwc(ss), js, bf16, "sample scale")
    if not bf16:
        _close(nhwc(sx), jx, bf16, "sample x")
        return
    # x = loc + scale eps: with the loc within e of its scale and the scale
    # within e relative, a voxel is within e (1 + 2 |scale eps|)
    eps = nhwc(heads.draws[0])
    bound = BF16_SCALE_TOL * (1 + 2 * np.abs(np.asarray(js) * eps))
    err = np.abs(nhwc(sx) - np.asarray(jx))
    assert (err <= bound).all(), (err / bound).max()


def test_train_steps_3d_match_jax(monkeypatch):
    """Three updates and one skipped step (a NaN parent) of the float32 3-D
    HVAE on (B, 1, 8, 8, 8) uint8 batches."""
    jcfg = jget("vol3d32", dtype="float32", **ARCH)
    tcfg = tget("vol3d32", dtype="float32", **ARCH)
    patch_jax_nll_with_port(monkeypatch)
    metrics, jstate, tstate = run_steps_against_jax(jcfg, tcfg, 1, 2, monkeypatch,
                                                    params=_pair("float32")[1])
    assert [tm["skipped"] for _, tm in metrics] == [0.0, 0.0, 1.0, 0.0]
    assert_states_match(metrics, jstate, tstate)


def test_vol3d_builder_is_the_jax_builder():
    """The port's own copy of make_vol3d and the vol3d builder give JAX's
    arrays for a seed; setup_datasets dispatches vol3d32 to it."""
    from causal_gen_tpu.data import datasets as jds
    from causal_gen_tpu_torch.data import datasets as tds

    assert tds.VOL3D_MIN_MAX == jds.VOL3D_MIN_MAX
    vols, raw = tds.make_vol3d(5, 12, seed=3)
    jvols, jraw = jds.make_vol3d(5, 12, seed=3)
    np.testing.assert_array_equal(vols, jvols)
    assert sorted(raw) == sorted(jraw)
    for k in raw:
        np.testing.assert_array_equal(raw[k], jraw[k])
    cfg = tget("vol3d32", input_res=8, seed=4)
    got = tds.setup_datasets(cfg)
    ref = jds.setup_datasets(jget("vol3d32", input_res=8, seed=4))
    for split in ("train", "valid"):
        np.testing.assert_array_equal(got[split].images, ref[split].images)
        np.testing.assert_array_equal(got[split].pa, ref[split].pa)
    batch = got["train"].batch(np.arange(3))
    assert batch["x"].shape == (3, 8, 8, 8, 1) and batch["pa"].shape == (3, 2)
