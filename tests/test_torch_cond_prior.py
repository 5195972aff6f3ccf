"""The conditional prior (``cond_prior``) and ``q_correction`` HVAEs of the port
against the JAX package's, on the small Morpho-MNIST config of
tests/test_dscm.py at bs 2 (``cond_drop_from`` 2, context 12), with
converted parameters drawn from a seed (torch_parity.random_jax_params: no
leaf is zero, so the parents reach each prior) and the same injected draws:
the ELBO without and with conditioning dropout (JAX's ``_drop_cond`` option
forced through a patched ``jax.random.randint``, each of 0/1/2), train
steps over the three options, the abduction's
``{z, q_loc, q_logscale}`` dicts, the mixture abduction, ``DSCM.forward``,
and a ``q_correction`` model's ELBO and steps.

Tolerances: latents, stats and images 1e-5 abs; ELBO terms 1e-4 rel;
``DSCM.forward`` and the train steps as tests/test_torch_dscm.py and
tests/test_torch_train.py hold them (1e-4; parameters 1e-5 abs). The NLL
goes through one function on both sides (torch_parity.patch_jax_nll_with_port).
Each JAX program is jitted once; the dropout option is read at run time.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.pgm.dscm import DSCM as JDSCM
from causal_gen_tpu.pgm.flow_pgm import MorphoMNISTPGM as JMorphoPGM
from causal_gen_tpu_torch.convert import params_from_jax
from causal_gen_tpu_torch.models.hvae import HVAE, plan_decoder_blocks
from causal_gen_tpu_torch.pgm.dscm import DSCM
from causal_gen_tpu_torch.pgm.flow_pgm import MorphoMNISTPGM

from tests.torch_parity import (
    assert_states_match,
    jax_batch,
    load_jax_params,
    nchw,
    nhwc,
    patch_jax_drop_option,
    patch_jax_nll_with_port,
    patch_jax_noise,
    random_jax_params,
    run_steps_against_jax,
    small_morpho_cfg,
    synth_batch,
    to_numpy,
    torch_batch,
)

torch.set_num_threads(1)

N = 2
VARIANTS = {"cp": dict(cond_prior=True), "qc": dict(q_correction=True)}


def _cfgs(variant):
    return tuple(small_morpho_cfg(side, **VARIANTS[variant]).replace(bs=N)
                 for side in (True, False))


@functools.cache
def _pair(variant):
    """The JAX HVAE of ``variant`` ("cp" or "qc"), parameters for it from a
    seed, and the port's HVAE loaded from them with ``strict=True``."""
    jcfg, tcfg = _cfgs(variant)
    jvae = JHVAE(cfg=jcfg)
    params = random_jax_params(jvae, jcfg)
    tvae = HVAE(tcfg, device="cpu")
    tvae.load_state_dict(params_from_jax(to_numpy(params)), strict=True)
    return jvae, params, tvae


def _batch(seed=0):
    b = synth_batch(16, N, seed)
    return b["x"], np.concatenate([b["thickness"], b["intensity"], b["digit"]], axis=1)


def _n_stochastic(tvae):
    return len(plan_decoder_blocks(tvae.cfg))


@functools.cache
def _jax_elbos(variant):
    """JAX's ELBO terms on one batch: in evaluation and, in training, under
    dropout options 0, 1 and 2 (one compile per mode), with the posterior
    draws of each."""
    jvae, params, _ = _pair(variant)
    x, pa = _batch(1)
    out = {}
    with pytest.MonkeyPatch.context() as m:
        patch_jax_nll_with_port(m)
        drop = patch_jax_drop_option(m)
        for train in (False, True):
            rec = patch_jax_noise(m, seed=11)
            fn = jax.jit(lambda p, a, b, train=train: jvae.apply(
                {"params": p}, a, b, beta=1.0, train=train,
                rngs={"sample": jax.random.PRNGKey(3)}))
            for opt in ((0, 1, 2) if train else (None,)):
                drop.option = opt or 0
                ref = fn(params, jnp.asarray(x), jnp.asarray(pa))
                out[opt if train else "eval"] = (
                    {k: float(v) for k, v in ref.items()}, rec.torch_noise())
    return x, pa, out


@pytest.mark.parametrize("case", ["eval", 0, 1, 2])
def test_elbo_with_and_without_dropout_matches_jax(case):
    """train=False reads the raw parents; train=True takes the option first
    in the draws, and option 0 zeroes the digit in the priors' input only."""
    x, pa, refs = _jax_elbos("cp")
    ref, draws = refs[case]
    _, _, tvae = _pair("cp")
    head = [] if case == "eval" else [torch.tensor(case)]
    with torch.no_grad():
        out = tvae(nchw(x), torch.from_numpy(pa), beta=1.0, noise=iter(head + draws),
                   train=case != "eval")
    for k in ("elbo", "nll", "kl"):
        np.testing.assert_allclose(float(out[k]), ref[k], rtol=1e-4, err_msg=k)
    if case != "eval":  # option 0 moved the KL; options 1 and 2 leave it as it is
        assert (ref["kl"] != refs["eval"][0]["kl"]) == (case == 0)


def test_dropout_reaches_the_prior_only():
    """Option 0 zeroes pa[:, cond_drop_from:] in every prior's input; the
    posteriors and z_proj read the raw parents; without cond_drop_from no
    option is drawn and nothing is dropped."""
    _, _, tvae = _pair("cp")
    x, pa = _batch(2)
    seen = {"prior": [], "posterior": []}
    hooks = []
    for blk in tvae.decoder._blocks:
        hooks.append(blk.prior.register_forward_pre_hook(
            lambda m, a: seen["prior"].append(a[0][:, -12:, 0, 0].clone())))
        hooks.append(blk.posterior.register_forward_pre_hook(
            lambda m, a, w=blk.prior._convs[0].in_channels - 12: seen["posterior"].append(
                a[0][:, w:w + 12, 0, 0].clone())))
    draws = [torch.randn(N, 4, r, r) for r, _ in plan_decoder_blocks(tvae.cfg)]
    with torch.no_grad():
        tvae(nchw(x), torch.from_numpy(pa), noise=iter([torch.tensor(0)] + draws))
    for h in hooks:
        h.remove()
    pa_t = torch.from_numpy(pa)
    dropped = torch.cat([pa_t[:, :2], torch.zeros(N, 10)], dim=1)
    assert all(torch.equal(p, dropped) for p in seen["prior"])
    assert all(torch.equal(p, pa_t) for p in seen["posterior"])
    nodrop = HVAE(tvae.cfg.replace(cond_drop_from=None), device="cpu")
    nodrop.load_state_dict(tvae.state_dict())
    with torch.no_grad():  # the draws alone: no option is taken
        a = nodrop(nchw(x), pa_t, noise=iter(draws), train=True)
        b = nodrop(nchw(x), pa_t, noise=iter(draws), train=False)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_steps_over_the_dropout_options_match_jax(monkeypatch):
    """Four steps, options 1, 0, 0, 2, the third skipped (a NaN parent)."""
    jcfg, tcfg = _cfgs("cp")
    patch_jax_nll_with_port(monkeypatch)
    metrics, jstate, tstate = run_steps_against_jax(jcfg, tcfg, 1, 12, monkeypatch,
                                                    options=[1, 0, 0, 2],
                                                    params=_pair("cp")[1])
    assert [tm["skipped"] for _, tm in metrics] == [0.0, 0.0, 1.0, 0.0]
    assert_states_match(metrics, jstate, tstate)


@functools.cache
def _jax_abductions():
    """JAX's abduct dicts and, under the counterfactual parents, its mixture
    abduction at alpha 0.65 (t None and 0.5), each with its draws."""
    jvae, params, _ = _pair("cp")
    x, pa = _batch(3)
    cf_pa = pa.copy()
    cf_pa[:, 0] = 0.6
    cf_pa[:, 2:] = np.eye(10, dtype=np.float32)[[3, 7]]
    out = {}
    with pytest.MonkeyPatch.context() as m:
        for t in (None, 0.5):
            rec = patch_jax_noise(m, seed=13)
            kw = dict(method=jvae.abduct, rngs={"sample": jax.random.PRNGKey(4)}, t=t)
            dicts = jax.jit(lambda p, a, b: jvae.apply({"params": p}, a, b, **kw))(
                params, jnp.asarray(x), jnp.asarray(pa))
            rec_m = patch_jax_noise(m, seed=14)
            mix = jax.jit(lambda p, a, b, c: jvae.apply({"params": p}, a, b, c, 0.65, **kw))(
                params, jnp.asarray(x), jnp.asarray(pa), jnp.asarray(cf_pa))
            out[t] = (jax.device_get(dicts), rec.torch_noise(), jax.device_get(mix),
                      rec_m.torch_noise())
    return x, pa, cf_pa, out


def test_abduct_returns_the_dicts_jax_returns():
    x, pa, _, out = _jax_abductions()
    jd, draws, _, _ = out[None]
    _, _, tvae = _pair("cp")
    with torch.no_grad():
        td = tvae.abduct(nchw(x), torch.from_numpy(pa), noise=iter(draws))
    assert len(td) == len(jd) == _n_stochastic(tvae)
    for i, (a, b) in enumerate(zip(td, jd)):
        assert sorted(a) == sorted(b) == ["q_loc", "q_logscale", "z"]
        for k in a:
            np.testing.assert_allclose(nhwc(a[k]), b[k], atol=1e-5, err_msg=f"{i} {k}")


@pytest.mark.parametrize("t", [None, 0.5])
def test_mixture_abduction_matches_jax(t):
    """abduct(x, pa, cf_parents, alpha=0.65, t): the posterior pass, then a
    prior pass under cf_parents (its draws after the posterior's)."""
    x, pa, cf_pa, out = _jax_abductions()
    _, _, jmix, draws = out[t]
    _, _, tvae = _pair("cp")
    n = _n_stochastic(tvae)
    assert len(draws) == 2 * n
    with torch.no_grad():
        tmix = tvae.abduct(nchw(x), torch.from_numpy(pa), torch.from_numpy(cf_pa), 0.65,
                           noise=iter(draws), t=t)
        plain = tvae.abduct(nchw(x), torch.from_numpy(pa), noise=iter(draws[:n]), t=t)
    assert len(tmix) == n
    for i, (a, b) in enumerate(zip(tmix, jmix)):
        np.testing.assert_allclose(nhwc(a), b, atol=1e-5, err_msg=str(i))
    assert max((a - b["z"]).abs().max().item() for a, b in zip(tmix, plain)) > 1e-3


def test_dscm_forward_with_cond_prior_matches_jax(monkeypatch):
    """DSCM.forward do(thickness = 0.5) with a cond_prior HVAE and the
    Morpho-MNIST PGM and predictor (tests/test_dscm.py::build_dscm's): the
    abduction's dicts are unwrapped before the decodes, and the factual pass
    runs without dropout."""
    jvae, params, tvae = _pair("cp")
    jpgm, jpred = JMorphoPGM(setup_predictors=False), JMorphoPGM(setup_predictors=True,
                                                                  input_res=16)
    attrs = {k: v for k, v in jax_batch(synth_batch(16, N, seed=9)).items() if k != "x"}
    key = jax.random.PRNGKey(1)
    frozen = to_numpy({
        "pgm": jpgm.init({"params": key, "sample": key}, attrs)["params"],
        "predictor": jpred.init({"params": key, "sample": key}, jnp.zeros((N, 16, 16, 1)),
                                method=jpred.anticausal_logprob, **attrs)["params"]})
    jdscm = JDSCM(cfg=jvae.cfg, pgm=jpgm, predictor=jpred, vae=jvae, elbo_constraint=1.8)
    pgm = MorphoMNISTPGM(setup_predictors=False, device="cpu")
    load_jax_params(pgm, frozen["pgm"])
    pred = MorphoMNISTPGM(setup_predictors=True, input_res=16, device="cpu")
    load_jax_params(pred, frozen["predictor"], allow_missing="intensity_net")
    tdscm = DSCM(tvae.cfg, pgm, pred, tvae, elbo_constraint=1.8)
    batch = synth_batch(16, N, seed=4)
    rec = patch_jax_noise(monkeypatch, seed=21)
    patch_jax_nll_with_port(monkeypatch)
    ref = jax.jit(lambda *a: jdscm.forward(*a, jax.random.PRNGKey(0)))(
        jdscm.init_trainable(params), frozen, jax_batch(batch),
        {"thickness": jnp.full((N, 1), 0.5)})
    assert len(rec.draws) == 2 * _n_stochastic(tvae)
    with torch.no_grad():
        out = tdscm.forward(torch_batch(batch), {"thickness": torch.full((N, 1), 0.5)},
                            noise=rec.torch_noise())
    np.testing.assert_allclose(nhwc(out["cfs"]["x"]), np.asarray(ref["cfs"]["x"]), atol=1e-4)
    for k in ("elbo", "nll", "kl", "aux_loss", "loss"):
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)


def test_q_correction_elbo_and_latents_match_jax(monkeypatch):
    """The prior reads h; no block has a z_feat_proj, and the converted tree
    loads strictly without one."""
    jvae, params, tvae = _pair("qc")
    assert not any("z_feat_proj" in k for k in tvae.state_dict())
    x, pa = _batch(5)
    patch_jax_nll_with_port(monkeypatch)
    rec = patch_jax_noise(monkeypatch, seed=15)
    ref = jax.jit(lambda p, a, b: jvae.apply({"params": p}, a, b, beta=1.0, train=True,
                                             rngs={"sample": jax.random.PRNGKey(5)}))(
        params, jnp.asarray(x), jnp.asarray(pa))
    with torch.no_grad():
        out = tvae(nchw(x), torch.from_numpy(pa), beta=1.0, noise=iter(rec.torch_noise()))
    for k in ("elbo", "nll", "kl"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-4, err_msg=k)
    rec = patch_jax_noise(monkeypatch, seed=16)
    jloc, jscale = jax.jit(lambda p, b: jvae.apply(
        {"params": p}, [None] * 4, b, t=0.7, method=jvae.forward_latents,
        rngs={"sample": jax.random.PRNGKey(6)}))(params, jnp.asarray(pa))
    with torch.no_grad():
        loc, scale = tvae.forward_latents([None] * 4, torch.from_numpy(pa),
                                          noise=iter(rec.torch_noise()), t=0.7)
    np.testing.assert_allclose(nhwc(loc), np.asarray(jloc), atol=1e-5)
    np.testing.assert_allclose(nhwc(scale), np.asarray(jscale), atol=1e-5)


def test_q_correction_train_steps_match_jax(monkeypatch):
    jcfg, tcfg = _cfgs("qc")
    patch_jax_nll_with_port(monkeypatch)
    metrics, jstate, tstate = run_steps_against_jax(jcfg, tcfg, 1, 12, monkeypatch,
                                                    params=_pair("qc")[1])
    assert [tm["skipped"] for _, tm in metrics] == [0.0, 0.0, 1.0, 0.0]
    assert_states_match(metrics, jstate, tstate)
