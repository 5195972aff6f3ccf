"""The port's SimpleVAE and GaussNet against the JAX package's
(causal_gen_tpu/models/simple_vae.py, likelihoods.py:109-174), with converted
parameters and the same draws: GaussNet's NLL (dequantisation uniforms
injected), sample and the gradients of its fixed / shared / diag log-scale;
SimpleVAE's ELBO, sample, abduct (cond_prior off and on, the mixture
abduction linear in alpha) and forward_latents on the registry's
morphomnist with ``vae="simple"`` and ``diag_gauss``; three train steps
(metrics, parameters and EMA); a DSCM.forward with the simple VAE; and
``cli.main --vae simple`` on the CPU.

Tolerances: 1e-5 rel on the ELBO terms and 1e-5 abs on images and latents
(the same float32 formulas; convs and dense layers differ in their
summation order only), 1e-4 rel on train metrics and 1e-5 abs on parameters
after three updates, as tests/test_torch_train.py holds the HVAE step.
Draws reach the JAX side through a patched ``sample_gaussian``,
``jax.random.uniform`` / ``normal`` and ``randint`` (the dropout option)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.config import get_config as jget_config
from causal_gen_tpu.models import likelihoods as jlik
from causal_gen_tpu.models.simple_vae import SimpleVAE as JSimpleVAE
from causal_gen_tpu_torch.config import get_config
from causal_gen_tpu_torch.convert import params_from_jax
from causal_gen_tpu_torch.models import likelihoods as tlik
from causal_gen_tpu_torch.models.simple_vae import SimpleVAE

from tests.torch_parity import (
    NoiseRecorder,
    assert_states_match,
    nchw,
    nhwc,
    patch_jax_draws,
    patch_jax_drop_option,
    to_numpy,
)

torch.set_num_threads(2)

N = 4


def _cfgs(cond_prior=False, x_like="diag_gauss", **kw):
    over = dict(vae="simple", x_like=x_like, cond_prior=cond_prior, bs=N, **kw)
    return jget_config("morphomnist", **over), get_config("morphomnist", **over)


def _randomise(tree, seed):
    """Every leaf drawn anew: kernels N(0, 1/fan_in), the rest their init +
    0.1 N(0, 1), so the zero-initialised prior heads carry signal."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "kernel":
            return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
                    ).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return to_numpy(jax.tree_util.tree_map_with_path(leaf, tree))


def _pair(cond_prior=False, x_like="diag_gauss", seed=0, **kw):
    jcfg, tcfg = _cfgs(cond_prior, x_like, **kw)
    jvae = JSimpleVAE(cfg=jcfg)
    x = jnp.zeros((1, 32, 32, 1))
    pa = jnp.zeros((1, jcfg.context_dim))
    k = jax.random.PRNGKey(seed)
    params = _randomise(jvae.init({"params": k, "sample": k}, x, pa, train=False)["params"],
                        seed)
    tvae = SimpleVAE(tcfg, device="cpu")
    tvae.load_state_dict(params_from_jax(params), strict=True)
    return jvae, params, tvae


def _batch(seed, n=N):
    rng = np.random.default_rng(seed)
    x = ((rng.integers(0, 256, (n, 32, 32, 1)) - 127.5) / 127.5).astype(np.float32)
    pa = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                         np.eye(10)[rng.integers(0, 10, n)]], 1).astype(np.float32)
    return x, pa


def _patch(monkeypatch, seed):
    import causal_gen_tpu.models.simple_vae as jsv

    rec = NoiseRecorder(seed)
    monkeypatch.setattr(jsv, "sample_gaussian", rec)
    return rec, patch_jax_draws(monkeypatch, seed + 1, "uniform")


# ---------------------------------------------------------------------------
# GaussNet
# ---------------------------------------------------------------------------


def _heads(x_like, std_init, seed=0, width=16, c=1):
    jhead = jlik.GaussNet(input_channels=c, width=width, x_like=x_like, std_init=std_init)
    h = np.random.default_rng(seed).normal(0, 1, (3, 8, 8, width)).astype(np.float32)
    k = jax.random.PRNGKey(seed)
    params = jhead.init({"params": k, "sample": k}, jnp.asarray(h))["params"]
    params = _randomise(params, seed) if std_init == 0 else to_numpy(params)
    thead = tlik.GaussNet(c, width, x_like, std_init)
    thead.load_state_dict(params_from_jax(params), strict=True)
    return jhead, params, thead, h


@pytest.mark.parametrize("x_like,std_init", [("diag_gauss", 0.0), ("shared_gauss", 1.0),
                                             ("fixed_gauss", 0.5)])
def test_gaussnet_nll_and_sample_match_jax(monkeypatch, x_like, std_init):
    jhead, params, thead, h = _heads(x_like, std_init)
    x = ((np.random.default_rng(1).integers(0, 256, (3, 8, 8, 1)) - 127.5) / 127.5
         ).astype(np.float32)
    uni = patch_jax_draws(monkeypatch, 2, "uniform")
    ref = jhead.apply({"params": params}, jnp.asarray(h), jnp.asarray(x), method=jhead.nll,
                      rngs={"sample": jax.random.PRNGKey(0)})
    got = thead.nll(nchw(h), nchw(x), u=nchw(uni.draws[0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5)
    eps = np.random.default_rng(3).standard_normal((3, 8, 8, 1)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(eps))
    for return_loc in (True, False):
        jx, js = jhead.apply({"params": params}, jnp.asarray(h), return_loc, 0.7,
                             method=jhead.sample, rngs={"sample": jax.random.PRNGKey(1)})
        tx, ts = thead.sample(nchw(h), return_loc, 0.7, noise=nchw(eps))
        np.testing.assert_allclose(nhwc(tx), np.asarray(jx), atol=1e-5)
        np.testing.assert_allclose(nhwc(ts), np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize("x_like", ["diag_gauss", "shared_gauss", "fixed_gauss"])
def test_gaussnet_gradients_match_jax(monkeypatch, x_like):
    """With std_init > 0, "shared" stops the log-scale kernel's gradient and
    "fixed" the kernel's and the bias's (detach here, stop_gradient there);
    "diag" stops neither."""
    jhead, params, thead, h = _heads(x_like, 1.0, seed=4)
    x = ((np.random.default_rng(5).integers(0, 256, (3, 8, 8, 1)) - 127.5) / 127.5
         ).astype(np.float32)
    uni = patch_jax_draws(monkeypatch, 6, "uniform")

    def loss(p):
        return jnp.mean(jhead.apply({"params": p}, jnp.asarray(h), jnp.asarray(x),
                                    method=jhead.nll, rngs={"sample": jax.random.PRNGKey(0)}))

    jgrads = params_from_jax(to_numpy(jax.grad(loss)(params)))
    thead.nll(nchw(h), nchw(x), u=nchw(uni.draws[0])).mean().backward()
    for name, p in thead.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    stopped = {"diag_gauss": (), "shared_gauss": ("x_logscale_kernel",),
               "fixed_gauss": ("x_logscale_kernel", "x_logscale_bias")}[x_like]
    for name, p in thead.named_parameters():
        moved = p.grad is not None and p.grad.abs().sum() > 0
        assert moved == (name not in stopped), name


# ---------------------------------------------------------------------------
# SimpleVAE
# ---------------------------------------------------------------------------


def test_encoder_and_decoder_geometry():
    """Conv(5, s2, p1) 32 -> 15, then (3, 2, 1) -> 8 -> 4; the decoder
    upsamples 4 -> 8 -> 16 -> 32 to 16 channels."""
    _, tcfg = _cfgs()
    vae = SimpleVAE(tcfg, device="cpu")
    h = torch.zeros(2, 1, 32, 32)
    sizes = []
    for conv in (vae.encoder.Conv_0, vae.encoder.Conv_1, vae.encoder.Conv_2):
        h = conv(h)
        sizes.append(h.shape[-1])
    assert sizes == [15, 8, 4]
    out, _ = vae.decoder(torch.zeros(2, tcfg.context_dim), z=torch.zeros(2, tcfg.z_dim))
    assert out.shape == (2, 16, 32, 32)


@pytest.mark.parametrize("cond_prior", [False, True])
def test_elbo_matches_jax(monkeypatch, cond_prior):
    jvae, params, tvae = _pair(cond_prior, seed=1)
    x, pa = _batch(2)
    rec, uni = _patch(monkeypatch, 3)
    ref = jvae.apply({"params": params}, jnp.asarray(x), jnp.asarray(pa), beta=1.5, train=False,
                     rngs={"sample": jax.random.PRNGKey(0)})
    assert len(rec.draws) == 1 and len(uni.draws) == 1
    noise = [torch.from_numpy(rec.draws[0]), nchw(uni.draws[0])]
    with torch.no_grad():
        out = tvae(nchw(x), torch.from_numpy(pa), beta=1.5, noise=iter(noise), train=False)
    for k in ("elbo", "nll", "kl"):
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("cond_prior", [False, True])
@pytest.mark.parametrize("return_loc", [True, False])
def test_sample_matches_jax(monkeypatch, cond_prior, return_loc):
    jvae, params, tvae = _pair(cond_prior, seed=2)
    _, pa = _batch(3)
    rec, _ = _patch(monkeypatch, 4)
    eps = np.random.default_rng(5).standard_normal((N, 32, 32, 1)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    jx, js = jvae.apply({"params": params}, jnp.asarray(pa), return_loc, 0.7,
                        method=jvae.sample, rngs={"sample": jax.random.PRNGKey(0)})
    noise = [torch.from_numpy(rec.draws[0])] + ([] if return_loc else [nchw(eps)])
    with torch.no_grad():
        tx, ts = tvae.sample(torch.from_numpy(pa), return_loc, 0.7, noise=iter(noise))
    np.testing.assert_allclose(nhwc(tx), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(nhwc(ts), np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize("cond_prior,mixture", [(False, False), (True, False), (True, True)])
def test_abduct_and_forward_latents_match_jax(monkeypatch, cond_prior, mixture):
    """abduct without cond_prior (z), with it ({z, q_loc, q_logscale}) and
    the mixture abduction under cf parents at alpha 0.65 and t 0.8 (linear
    in alpha); then forward_latents of the latent under the cf parents."""
    jvae, params, tvae = _pair(cond_prior, seed=3)
    x, pa = _batch(6)
    cf = pa.copy()
    cf[:, 0] = 0.5
    rec, _ = _patch(monkeypatch, 7)
    extra = (jnp.asarray(cf), 0.65, 0.8) if mixture else ()
    jz = jvae.apply({"params": params}, jnp.asarray(x), jnp.asarray(pa), *extra,
                    method=jvae.abduct, rngs={"sample": jax.random.PRNGKey(0)})
    targs = dict(cf_parents=torch.from_numpy(cf), alpha=0.65, t=0.8) if mixture else {}
    with torch.no_grad():
        tz = tvae.abduct(nchw(x), torch.from_numpy(pa), noise=iter(rec.torch_noise()), **targs)
    assert len(tz) == len(jz) == 1
    if cond_prior and not mixture:
        for k in ("z", "q_loc", "q_logscale"):
            np.testing.assert_allclose(tz[0][k].numpy(), np.asarray(jz[0][k]), atol=1e-5)
        z = np.array(jz[0]["z"])
    else:
        np.testing.assert_allclose(tz[0].numpy(), np.asarray(jz[0]), atol=1e-5)
        z = np.array(jz[0])
    jloc, jscale = jvae.apply({"params": params}, [jnp.asarray(z)], jnp.asarray(cf),
                              method=jvae.forward_latents)
    with torch.no_grad():
        tloc, tscale = tvae.forward_latents([torch.from_numpy(z)], torch.from_numpy(cf))
    np.testing.assert_allclose(nhwc(tloc), np.asarray(jloc), atol=1e-5)
    np.testing.assert_allclose(nhwc(tscale), np.asarray(jscale), rtol=1e-5)


@pytest.mark.parametrize("cond_prior", [False, True])
def test_three_train_steps_match_jax(monkeypatch, cond_prior):
    """Three updates of the JAX package's jitted step and the port's
    train_step from the same parameters, batches and draws (the JAX step
    traces once, so its draws serve every step); under cond_prior the
    dropout options 0, 1, 2 in turn. Metrics 1e-4 rel, parameters and EMA
    1e-5 abs."""
    from causal_gen_tpu.train.state import init_train_state as jinit_state
    from causal_gen_tpu.train.vae_trainer import _make_step_body
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import train_step

    jvae, params, tvae = _pair(cond_prior, seed=4)
    jcfg, tcfg = _cfgs(cond_prior)
    jstate, tstate = jinit_state(jcfg, params), init_train_state(tcfg, tvae)
    rec, uni = _patch(monkeypatch, 8)
    drop = patch_jax_drop_option(monkeypatch) if cond_prior else None
    jstep = jax.jit(_make_step_body(jcfg, jvae))
    rng = np.random.default_rng(9)
    metrics = []
    for s in range(3):
        x = rng.integers(0, 256, (1, N, 32, 32, 1)).astype(np.uint8)
        _, pa = _batch(10 + s)
        head = []
        if drop is not None:
            drop.option = s
            head = [torch.tensor(s)]
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "pa": jnp.asarray(pa[None])},
                           jax.random.PRNGKey(s))
        noise = [head + [torch.from_numpy(rec.draws[0]), nchw(uni.draws[0])]]
        tm = train_step(tcfg, tstate, {"x": torch.from_numpy(x[0]).permute(0, 3, 1, 2),
                                       "pa": torch.from_numpy(pa)}, noise=noise)
        metrics.append(({k: float(v) for k, v in jax.device_get(jm).items()},
                        {k: float(v) for k, v in tm.items()}))
    assert len(rec.draws) == 1 and len(uni.draws) == 1
    assert_states_match(metrics, jstate, tstate)


def test_dscm_forward_with_the_simple_vae_matches_jax(monkeypatch):
    """DSCM.forward do(thickness) with SimpleVAE + GaussNet as the image
    mechanism, on tests/test_torch_dscm.py's PGM and predictor (16^2 there;
    32^2 here, the simple VAE's only size): cf_x 1e-4, the terms 1e-4 rel."""
    from causal_gen_tpu.pgm.dscm import DSCM as JDSCM
    from causal_gen_tpu_torch.pgm.dscm import DSCM
    from tests.torch_parity import pgm_pair

    jvae, vparams, tvae = _pair(False, seed=5)
    jcfg, tcfg = _cfgs()
    jpgm, pgm_tree, tpgm, obs = pgm_pair("morphomnist", "pgm", n=N, seed=1)
    jpred, pred_tree, tpred, _ = pgm_pair("morphomnist", "aux", n=N, seed=2)
    obs["x"] = _batch(11)[0]
    jdscm = JDSCM(cfg=jcfg, pgm=jpgm, predictor=jpred, vae=jvae, elbo_constraint=1.8)
    tdscm = DSCM(tcfg, tpgm, tpred, tvae, elbo_constraint=1.8)
    rec, uni = _patch(monkeypatch, 12)
    do = np.full((N, 1), 0.5, np.float32)
    ref = jdscm.forward(jdscm.init_trainable(vparams), {"pgm": pgm_tree, "predictor": pred_tree},
                        {k: jnp.asarray(v) for k, v in obs.items()}, {"thickness": jnp.asarray(do)},
                        jax.random.PRNGKey(0))
    noise = [torch.from_numpy(rec.draws[0]), nchw(uni.draws[0]), torch.from_numpy(rec.draws[1])]
    tobs = {k: nchw(v) if k == "x" else torch.from_numpy(v) for k, v in obs.items()}
    with torch.no_grad():
        out = tdscm.forward(tobs, {"thickness": torch.from_numpy(do)}, noise=noise)
    np.testing.assert_allclose(nhwc(out["cfs"]["x"]), np.asarray(ref["cfs"]["x"]), atol=1e-4)
    for k in ("elbo", "nll", "kl", "aux_loss", "loss"):
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)


def test_cli_main_trains_the_simple_vae(tmp_path):
    """cli.main --vae simple --x_like diag_gauss: two epochs of two batches on
    an in-memory dataset, an evaluation and a checkpoint, on the CPU."""
    from causal_gen_tpu_torch.cli.main import main
    from causal_gen_tpu_torch.data.datasets import ArrayDataset

    rng = np.random.default_rng(0)

    def ds(n):
        return ArrayDataset(
            images=rng.integers(0, 256, (n, 32, 32, 1)).astype(np.uint8),
            attrs={"thickness": rng.uniform(-1, 1, n).astype(np.float32),
                   "intensity": rng.uniform(-1, 1, n).astype(np.float32),
                   "digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]},
            columns=("thickness", "intensity", "digit"))

    state, history = main(["--hps", "morphomnist", "--vae", "simple", "--x_like", "diag_gauss",
                           "--device", "cpu", "--epochs", "2", "--eval_freq", "2", "--bs", "4",
                           "--max_batches", "2", "--save_dir", str(tmp_path)],
                          datasets={"train": ds(8), "valid": ds(4)})
    assert isinstance(state.model, SimpleVAE) and state.step == 4
    assert np.isfinite(history["valid_elbo"])
    assert (tmp_path / "checkpoint").exists()
