"""The ukbb192 slice against the JAX package, on a reduced UK Biobank config
that keeps every kind of block the flagship has: light blocks, covered
equal-width 3x3 blocks (K2's plain version on the CPU), down blocks with and
without a width_proj, k=1 blocks at res <= 2, z_max_res and bias_max_res
below input_res. The HVAE (ELBO terms, abduct, forward_latents, sample), in
float32 and in bf16, with the same injected noise; the bf16 stream's
dtypes; a bf16 train step's gradients; the full ukbb192 model builds.
DSCM.forward is in tests/test_torch_ukbb_dscm.py; the PGM, its nets, the
reader and the CLI in tests/test_torch_ukbb_pgm.py.

Tolerances. float32: 1e-5 abs + rel (the spline's logdet too, as in
tests/test_torch_pgm.py), ELBO terms 1e-5 rel. bf16: both sides round every
conv's output to 8 significant bits, but at other points (K2 rounds once a
block where the JAX block rounds each conv, each bias add and the residual
add; PyTorch's CPU bf16 convs round their own sums), and the differences
grow over the ~30 blocks of a pass. A latent or image tensor is held within
2^-4 of its scale, max(1, max |ref|) (16 bf16 ulps of its largest value;
measured over three batches: latents up to 1.6% of their scale, decoded
images and scales up to 2.7%), the ELBO terms within 2e-2 rel (measured up
to 0.7%). The NLL term goes through
one function on both sides (see torch_parity.patch_jax_nll_with_port).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.config import get_config as jget
from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu_torch.config import get_config as tget
from causal_gen_tpu_torch.models import hvae as thvae
from causal_gen_tpu_torch.models.blocks import Block
from causal_gen_tpu_torch.models.hvae import HVAE
from causal_gen_tpu_torch.pgm.flow_pgm import FlowPGM

from tests.torch_parity import (
    load_jax_params,
    nchw,
    nhwc,
    patch_jax_head_draws,
    patch_jax_nll_with_port,
    patch_jax_noise,
)
from tests.test_torch_ukbb_pgm import ARCH, N, RES, ukbb_obs

torch.set_num_threads(1)

N_STOCHASTIC = 7  # decoder blocks at res <= 16
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_SCALE_TOL, BF16_RTOL = 2.0 ** -4, 2e-2


def _cfgs(dtype):
    return (jget("ukbb192", dtype=dtype, bs=N, **ARCH),
            tget("ukbb192", dtype=dtype, bs=N, **ARCH))


@functools.cache
def _vae_pair(dtype):
    """The JAX HVAE, its parameters and the port's HVAE holding them; cached
    per dtype (the jitted JAX init compiles in ~10 s)."""
    jcfg, tcfg = _cfgs(dtype)
    jvae = JHVAE(cfg=jcfg)
    x, pa = jnp.zeros((1, RES, RES, 1)), jnp.zeros((1, jcfg.context_dim))
    params = jax.jit(lambda k: jvae.init({"params": k, "sample": k}, x, pa, beta=jcfg.beta,
                                         train=False))(jax.random.PRNGKey(0))["params"]
    # the zero-initialised leaves (the prior heads' last convs, the biases)
    # made random, so that every path carries signal
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 1000))
    params = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(next(keys), a.shape)
                          if not a.any() else a, params)
    tvae = HVAE(tcfg, device="cpu")
    load_jax_params(tvae, params)
    return jvae, params, tvae


def _japply(jvae, params, *args, **kw):
    """``jvae.apply`` jitted: one compile of the whole pass instead of one per
    op. The patched draws and NLL are traced in as constants and callbacks."""
    return jax.jit(lambda p, *a: jvae.apply({"params": p}, *a, **kw))(params, *args)


def _close(got, ref, bf16, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    if bf16:
        err, scale = np.abs(got - ref).max(), max(1.0, np.abs(ref).max())
        assert err <= BF16_SCALE_TOL * scale, (what, err, scale)
    else:
        np.testing.assert_allclose(got, np.asarray(ref, np.float32), err_msg=what, **F32_TOL)


def _scalar_close(got, ref, bf16, what=""):
    np.testing.assert_allclose(float(got), float(ref), rtol=BF16_RTOL if bf16 else 1e-5,
                               err_msg=what)


def _vae_parents(seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (N, 4)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elbo_matches_jax(monkeypatch, dtype):
    bf16 = dtype == "bfloat16"
    jvae, params, tvae = _vae_pair(dtype)
    x, pa = ukbb_obs()["x"], _vae_parents()
    rec = patch_jax_noise(monkeypatch, seed=11)
    patch_jax_nll_with_port(monkeypatch)
    ref = _japply(jvae, params, jnp.asarray(x), jnp.asarray(pa), beta=1.0, train=False,
                  rngs={"sample": jax.random.PRNGKey(3)})
    assert len(rec.draws) == N_STOCHASTIC
    with torch.no_grad():
        out = tvae(nchw(x), torch.from_numpy(pa), beta=1.0, noise=iter(rec.torch_noise()))
    for k in ("elbo", "nll", "kl"):
        _scalar_close(out[k], ref[k], bf16, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_abduct_forward_latents_and_sample_match_jax(monkeypatch, dtype):
    bf16 = dtype == "bfloat16"
    jvae, params, tvae = _vae_pair(dtype)
    x, pa, cf_pa = ukbb_obs(1)["x"], _vae_parents(1), _vae_parents(2)
    rec = patch_jax_noise(monkeypatch, seed=12)
    jz = _japply(jvae, params, jnp.asarray(x), jnp.asarray(pa), method=jvae.abduct,
                 rngs={"sample": jax.random.PRNGKey(4)})
    with torch.no_grad():
        tz = tvae.abduct(nchw(x), torch.from_numpy(pa), noise=iter(rec.torch_noise()))
    assert len(tz) == len(jz) == N_STOCHASTIC
    for i, (a, b) in enumerate(zip(tz, jz)):
        assert a.dtype == torch.float32
        _close(nhwc(a), b, bf16, f"z{i}")
    jloc, jscale = _japply(jvae, params, jz, jnp.asarray(cf_pa), method=jvae.forward_latents)
    with torch.no_grad():
        loc, scale = tvae.forward_latents([nchw(z) for z in jz], torch.from_numpy(cf_pa))
    _close(nhwc(loc), jloc, bf16, "loc")
    _close(nhwc(scale), jscale, bf16, "scale")

    prior = patch_jax_noise(monkeypatch, seed=14)
    heads = patch_jax_head_draws(monkeypatch, seed=15)
    jx, js = _japply(jvae, params, jnp.asarray(pa), method=jvae.sample, return_loc=False,
                     t=0.7, rngs={"sample": jax.random.PRNGKey(7)})
    with torch.no_grad():
        sx, ss = tvae.sample(torch.from_numpy(pa), False, 0.7,
                             noise=iter(prior.torch_noise() + heads.draws))
    assert sx.shape == (N, 1, RES, RES) and sx.dtype == torch.float32
    _close(nhwc(sx), jx, bf16, "sample x")
    _close(nhwc(ss), js, bf16, "sample scale")


def test_bf16_stream_is_bf16_and_stats_are_f32(monkeypatch):
    """Between blocks the residual stream is bf16; the prior and posterior
    stats that K1 and the KL read are float32; parameters stay float32."""
    tvae = HVAE(_cfgs("bfloat16")[1], device="cpu", generator=torch.Generator().manual_seed(0))
    seen = {"block_out": set(), "stats": set()}
    for m in tvae.modules():
        if isinstance(m, Block):
            m.register_forward_hook(lambda mod, i, o: seen["block_out"].add(o.dtype))
    orig_prior, orig_post = thvae.DecoderBlock.forward_prior, thvae.DecoderBlock.forward_posterior

    def prior(self, *a, **k):
        p_loc, p_logscale, p_feat = orig_prior(self, *a, **k)
        seen["stats"].update({p_loc.dtype, p_logscale.dtype})
        seen["block_out"].add(p_feat.dtype)
        return p_loc, p_logscale, p_feat

    def post(self, *a, **k):
        out = orig_post(self, *a, **k)
        seen["stats"].update(t.dtype for t in out)
        return out

    monkeypatch.setattr(thvae.DecoderBlock, "forward_prior", prior)
    monkeypatch.setattr(thvae.DecoderBlock, "forward_posterior", post)
    with torch.no_grad():
        acts = tvae.encoder(nchw(ukbb_obs()["x"]))
        tvae(nchw(ukbb_obs()["x"]), torch.from_numpy(_vae_parents()))
    assert {a.dtype for a in acts.values()} == {torch.bfloat16}
    assert seen == {"block_out": {torch.bfloat16}, "stats": {torch.float32}}
    assert {p.dtype for p in tvae.parameters()} == {torch.float32}


def test_bf16_train_step_grads_are_f32():
    """A bf16 train step differentiates through the per-op convs (K2 is off
    under autograd) and gives float32 gradients of the float32 parameters."""
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import train_step

    _, tcfg = _cfgs("bfloat16")
    tvae = HVAE(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = init_train_state(tcfg, tvae)
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.integers(0, 256, (N, 1, RES, RES)).astype(np.uint8)),
             "pa": torch.from_numpy(_vae_parents())}
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.dtype))
             for n, p in tvae.named_parameters()]
    m = train_step(tcfg, state, batch, generator=torch.Generator().manual_seed(1))
    for h in hooks:
        h.remove()
    assert m["skipped"] == 0.0 and all(np.isfinite(float(m[k])) for k in ("elbo", "grad_norm"))
    assert set(grads.values()) == {torch.float32} and len(grads) > 0
    assert state.step == 1


def test_full_ukbb192_builds_in_bf16():
    """The registry's ukbb192 HVAE builds as it is (bf16 convs, float32
    parameters), with the FlowPGM at 192^2."""
    cfg = tget("ukbb192")
    vae = HVAE(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert cfg.dtype == "bfloat16" and vae.decoder.dtype == torch.bfloat16
    assert {p.dtype for p in vae.parameters()} == {torch.float32}
    pgm = FlowPGM(input_res=cfg.input_res, device="cpu")
    assert sum(p.numel() for p in pgm.parameters()) > 0
