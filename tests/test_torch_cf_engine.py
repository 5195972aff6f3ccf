"""The rest of the counterfactual engine against the JAX package: the
Gumbel helpers of ``ops/distributions.py``, ``SoftmaxCentered`` (round trip
and per-event logdet) and ``Compose`` over it, ``flow_logprob`` with the
normal and the Gumbel base, ``ancestral_sample``, ``joint_logprob`` and
``counterfactual_dense`` of all four PGMs, the dense counterfactual against
the sparse one on every do pattern, ``DSCM.forward(do_mask=...)`` on
Morpho-MNIST, and the axioms of tests/test_discrete_mechanism.py on the
port's Gumbel-Softmax mechanism.

Tolerances: 1e-5 abs + rel on the PGM sites and transforms (float32 math of
the same formulas; the spline's knots are a cumsum that the two packages
round one ulp apart, see tests/test_torch_pgm.py), 1e-4 on DSCM.forward as
tests/test_torch_dscm.py holds it. Draws reach the JAX side through patched
``jax.random`` functions and the port as injected ``noise``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.ops import distributions as jd
from causal_gen_tpu.pgm import base as jbase
from causal_gen_tpu.pgm import transforms as jt
from causal_gen_tpu_torch.ops import distributions as td
from causal_gen_tpu_torch.pgm import base as tbase
from causal_gen_tpu_torch.pgm import transforms as tt

from tests.torch_parity import nchw, nhwc, patch_jax_draws, patch_jax_gumbel, patch_jax_noise
from tests.torch_parity import patch_jax_nll_with_port, pgm_pair, synth_batch, torch_batch

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
DATASETS = ("morphomnist", "cmnist", "ukbb", "mimic")


def _np(t):
    return t.detach().cpu().numpy()


def _attrs(obs, torch_side):
    return {k: torch.from_numpy(v) if torch_side else jnp.asarray(v)
            for k, v in obs.items() if k != "x"}


def test_gumbel_logpdf_and_draws_match_jax():
    rng = np.random.default_rng(0)
    x, loc = rng.normal(0, 2, (2, 64)).astype(np.float32)
    scale = rng.uniform(0.3, 3, 64).astype(np.float32)
    np.testing.assert_allclose(
        _np(td.gumbel_logpdf(*map(torch.from_numpy, (x, loc, scale)))),
        np.asarray(jd.gumbel_logpdf(*map(jnp.asarray, (x, loc, scale)))), **TOL)
    # the one-hot draw is argmax(g + logits), as jax.random.categorical draws it
    logits = rng.normal(0, 1, (32, 7)).astype(np.float32)
    g = rng.gumbel(size=(32, 7)).astype(np.float32)
    got = td.sample_onehot_categorical(torch.from_numpy(logits), gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(_np(got), np.eye(7)[np.argmax(g + logits, -1)])
    # drawn from a generator: shape, one-hot, and the classes' frequencies
    draws = td.sample_onehot_categorical(torch.tensor([[0.0, 1.0, 2.0]]), (40000,),
                                         generator=torch.Generator().manual_seed(0))
    freq = _np(draws.mean(0))
    np.testing.assert_allclose(freq, np.exp([0, 1, 2]) / np.exp([0, 1, 2]).sum(), atol=0.01)
    gum = td.sample_gumbel((200000,), torch.Generator().manual_seed(1), loc=1.0, scale=2.0)
    assert abs(gum.mean().item() - (1.0 + 2.0 * 0.5772157)) < 0.02


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_softmax_centered_matches_jax(temperature):
    """Round trip and the per-event logdet (the last dim reduced), with the
    1e-12 floors where JAX has them: rows near a vertex of the simplex too."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (64, 4)).astype(np.float32)
    x[:4] *= 12.0  # some y at the floor
    js, ts = jt.SoftmaxCentered(temperature), tt.SoftmaxCentered(temperature)
    jy, jld = js.forward(jnp.asarray(x))
    ty, tld = ts.forward(torch.from_numpy(x))
    assert tld.shape == (64,)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(tld), np.asarray(jld), **TOL)
    jx, jild = js.inverse(jy)
    tx, tild = ts.inverse(ty)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(_np(tild), np.asarray(jild), **TOL)
    ok = np.abs(x).max(-1) < 10  # away from the floor the round trip is exact
    np.testing.assert_allclose(_np(tx)[ok], x[ok], atol=1e-4)


def _affine_softmax(lib, loc, log_scale):
    return lib.Compose([lib.Affine(loc=loc, log_scale=log_scale), lib.SoftmaxCentered()])


@pytest.mark.parametrize("base", ["normal", "gumbel"])
def test_flow_logprob_matches_jax(base):
    """Both logdet branches: elementwise (affine then the Morpho-MNIST
    squashing tail) and per event (affine then SoftmaxCentered, through
    Compose's mixed accumulation)."""
    rng = np.random.default_rng(2)
    loc, ls = rng.normal(0, 0.5, (2, 16, 3)).astype(np.float32)
    y_simplex = rng.dirichlet(np.ones(4), 16).astype(np.float32)
    y_line = rng.uniform(-0.9, 0.9, (16, 1)).astype(np.float32)
    cases = [
        (lambda lib, a: lib.Compose([lib.Affine(loc=a(loc[:, :1]), log_scale=a(ls[:, :1])),
                                     *lib.normalize_neg11().parts]), y_line),
        (lambda lib, a: _affine_softmax(lib, a(loc), a(ls)), y_simplex),
    ]
    for make, y in cases:
        jlp = jbase.flow_logprob(make(jt, jnp.asarray), jnp.asarray(y), base)
        tlp = tbase.flow_logprob(make(tt, torch.from_numpy), torch.from_numpy(y), base)
        assert tlp.shape == (16,)
        np.testing.assert_allclose(_np(tlp), np.asarray(jlp), **TOL)


def _mechanism(lib, w, b):
    """x (flow, dim 2) -> y (3-class simplex through a Gumbel-base flow,
    Affine then SoftmaxCentered): tests/test_discrete_mechanism.py's SCM,
    built with ``lib`` (the JAX or the port's base module)."""
    tf = jt if lib is jbase else tt
    zero = jnp.float32(0.0) if lib is jbase else 0.0

    def y_t(values):
        loc = values["x"] @ w + b
        return tf.Compose([tf.Affine(loc=loc, log_scale=loc * 0.0), tf.SoftmaxCentered()])

    return [lib.Node("x", lib.FLOW, transform_fn=lambda v: tf.Affine(loc=zero, log_scale=zero),
                     dim=2),
            lib.Node("y", lib.FLOW, ("x",), transform_fn=y_t, dim=2, base="gumbel", out_dim=3)]


@pytest.fixture
def mechanisms():
    w = (2.0 * np.random.default_rng(3).standard_normal((2, 2))).astype(np.float32)
    b = np.zeros(2, np.float32)
    return (_mechanism(jbase, jnp.asarray(w), jnp.asarray(b)),
            _mechanism(tbase, torch.from_numpy(w), torch.from_numpy(b)))


def test_ancestral_sample_and_joint_logprob_match_jax(monkeypatch, mechanisms):
    """The Gumbel-base flow node through ancestral_sample with its draws
    injected, then joint_logprob and the sparse counterfactual, each against
    JAX."""
    jn, tn = mechanisms
    rec = patch_jax_draws(monkeypatch, 4, "normal", "gumbel")
    jv = jbase.ancestral_sample(jn, jax.random.PRNGKey(0), 32)
    tv = tbase.ancestral_sample(tn, 32, noise={"x": torch.from_numpy(rec.draws[0]),
                                               "y": torch.from_numpy(rec.draws[1])})
    for k in jv:
        np.testing.assert_allclose(_np(tv[k]), np.asarray(jv[k]), **TOL)
    jlp, tlp = jbase.joint_logprob(jn, jv), tbase.joint_logprob(tn, tv)
    for k in jlp:
        np.testing.assert_allclose(_np(tlp[k]), np.asarray(jlp[k]), atol=1e-4, rtol=1e-5)
    new_x = np.random.default_rng(5).uniform(-1, 1, (32, 2)).astype(np.float32)
    jcf = jbase.counterfactual(jn, jax.random.PRNGKey(1), jv, {"x": jnp.asarray(new_x)})
    tcf = tbase.counterfactual(tn, tv, {"x": torch.from_numpy(new_x)})
    for k in jcf:
        np.testing.assert_allclose(_np(tcf[k]), np.asarray(jcf[k]), atol=1e-4, rtol=1e-5)


class TestGumbelSoftmaxMechanism:
    """tests/test_discrete_mechanism.py's axioms (the reference notebook's
    cells 4-5) on the port's nodes."""

    def nodes(self):
        w = 2.0 * torch.randn((2, 2), generator=torch.Generator().manual_seed(0))
        return _mechanism(tbase, w, torch.zeros(2))

    def sample(self, n, seed):
        return tbase.ancestral_sample(self.nodes(), n, torch.Generator().manual_seed(seed))

    def test_ancestral_sample_on_simplex(self):
        y = self.sample(32, 1)["y"]
        assert y.shape == (32, 3)
        np.testing.assert_allclose(_np(y.sum(-1)), 1.0, atol=1e-5)
        assert (y >= 0).all()

    def test_null_counterfactual_reproduces_y(self):
        vals = self.sample(64, 2)
        cf = tbase.counterfactual(self.nodes(), vals, {})
        np.testing.assert_allclose(_np(cf["y"]), _np(vals["y"]), atol=1e-4)
        np.testing.assert_allclose(_np(cf["x"]), _np(vals["x"]), atol=1e-5)

    def test_cause_intervention_changes_effects(self):
        vals = self.sample(64, 4)
        new_x = 2 * torch.rand((64, 2), generator=torch.Generator().manual_seed(5)) - 1
        cf = tbase.counterfactual(self.nodes(), vals, {"x": new_x})
        before, after = vals["y"].argmax(-1), cf["y"].argmax(-1)
        assert (before != after).sum() > 0
        assert (before == after).sum() > 0  # abduction preserves the noise

    def test_joint_logprob_finite(self):
        lps = tbase.joint_logprob(self.nodes(), self.sample(16, 7))
        assert all(torch.isfinite(v).all() for v in lps.values())

    def test_transform_roundtrip(self):
        nodes, vals = self.nodes(), self.sample(8, 8)
        t = nodes[1].transform_fn(vals)
        y2, _ = t.forward(t.inverse(vals["y"])[0])
        np.testing.assert_allclose(_np(y2), _np(vals["y"]), atol=1e-5)


@pytest.mark.parametrize("dataset", DATASETS)
def test_svi_logprob_matches_jax(dataset):
    """joint_logprob of each PGM at the observed values (the Gumbel-Max
    finding through its categorical marginal)."""
    jpgm, tree, tpgm, obs = pgm_pair(dataset, "pgm")
    ref = jpgm.apply({"params": tree}, _attrs(obs, False), method=jpgm.svi_logprob)
    with torch.no_grad():
        got = tpgm.svi_logprob(_attrs(obs, True))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("dataset", ["morphomnist", "cmnist", "ukbb"])
def test_init_all_matches_jax(dataset):
    """The semi-supervised model's site log-probs, the SCM's and the
    predictors' together (the JAX package's init surface)."""
    jpgm, tree, tpgm, obs = pgm_pair(dataset, "semi", seed=4)
    ref = jpgm.apply({"params": tree}, jnp.asarray(obs["x"]), _attrs(obs, False),
                     method=jpgm.init_all)
    with torch.no_grad():
        got = tpgm.init_all(nchw(obs["x"]), _attrs(obs, True))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), atol=1e-4, rtol=1e-5,
                                   err_msg=k)


def _patterns(dataset):
    """Do patterns over a PGM's variables: none, each alone, and two together."""
    names = {"morphomnist": ("thickness", "intensity", "digit"), "cmnist": ("digit", "colour"),
             "ukbb": ("sex", "age", "brain_volume", "ventricle_volume"),
             "mimic": ("age", "finding", "race", "sex")}[dataset]
    return [()] + [(k,) for k in names] + [names[:2]]


def _do_values(obs, seed):
    """A do value for every variable: another sample of the same kind."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in obs.items():
        if k == "x":
            continue
        if v.shape[1] > 1:
            out[k] = np.eye(v.shape[1], dtype=np.float32)[rng.integers(0, v.shape[1], len(v))]
        elif set(np.unique(v)) <= {0.0, 1.0}:
            out[k] = 1.0 - v
        else:
            out[k] = rng.uniform(-0.8, 0.8, v.shape).astype(np.float32)
    return out


def _masks(dataset, names, n):
    """(n, 1) 0/1 masks of every variable, row i taking pattern
    i % len(patterns)."""
    pats = _patterns(dataset)
    rows = [pats[i % len(pats)] for i in range(n)]
    return {k: np.asarray([[float(k in r)] for r in rows], np.float32) for k in names}, rows


@pytest.mark.parametrize("dataset", DATASETS)
def test_counterfactual_dense_matches_jax_and_the_sparse_one(monkeypatch, dataset):
    """One pass with a row-wise mix of patterns against JAX's
    counterfactual_dense (the same Gumbel posterior draws), then against the
    port's sparse counterfactual on the rows of each pattern (MIMIC's
    finding restore included)."""
    n = 12
    jpgm, tree, tpgm, obs = pgm_pair(dataset, "pgm", n=n)
    dov = _do_values(obs, 9)
    masks, rows = _masks(dataset, dov, n)
    gum = patch_jax_gumbel(monkeypatch, seed=11)
    ref = jpgm.apply({"params": tree}, _attrs(obs, False), {k: jnp.asarray(v) for k, v in dov.items()},
                     {k: jnp.asarray(v) for k, v in masks.items()},
                     method=jpgm.counterfactual_dense, rngs={"sample": jax.random.PRNGKey(0)})
    draws = gum.torch_draws()
    tobs = _attrs(obs, True)
    tdo = {k: torch.from_numpy(v) for k, v in dov.items()}
    with torch.no_grad():
        got = tpgm.counterfactual_dense(tobs, tdo, {k: torch.from_numpy(v)
                                                    for k, v in masks.items()},
                                        noise=iter(draws))
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), **TOL, err_msg=k)
    for pat in set(rows):
        idx = [i for i, r in enumerate(rows) if r == pat]
        sub = {k: v[idx] for k, v in tobs.items()}
        sparse_noise = iter([d[idx] for d in draws])
        with torch.no_grad():
            sparse = tpgm.counterfactual(sub, {k: tdo[k][idx] for k in pat}, noise=sparse_noise)
        for k in sparse:
            np.testing.assert_allclose(_np(got[k][idx]), _np(sparse[k]), **TOL,
                                       err_msg=f"{pat} {k}")


def test_dscm_forward_with_do_mask_matches_jax(monkeypatch):
    """DSCM.forward(do_mask=...) on tests/test_dscm.py's Morpho-MNIST DSCM:
    rows under none, thickness, intensity, digit and thickness + intensity,
    against JAX's dense forward (1e-4, as test_torch_dscm.py), and each
    row's cf_x against the sparse forward of its pattern."""
    from tests.test_torch_dscm import _pair

    jdscm, trainable, frozen, tdscm = _pair()
    n = 10
    batch = synth_batch(16, n, seed=3)
    dov = _do_values({k: v for k, v in batch.items()}, 4)
    pats = [(), ("thickness",), ("intensity",), ("digit",), ("thickness", "intensity")]
    rows = [pats[i % len(pats)] for i in range(n)]
    masks = {k: np.asarray([[float(k in r)] for r in rows], np.float32)
             for k in ("thickness", "intensity", "digit")}
    rec = patch_jax_noise(monkeypatch, seed=21)
    patch_jax_nll_with_port(monkeypatch)
    ref = jax.jit(lambda t, f, o, d, m: jdscm.forward(t, f, o, d, jax.random.PRNGKey(0),
                                                      do_mask=m))(
        trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in dov.items()},
        {k: jnp.asarray(v) for k, v in masks.items()})
    noise = rec.torch_noise()
    tobs = torch_batch(batch)
    tdo = {k: torch.from_numpy(v) for k, v in dov.items()}
    with torch.no_grad():
        out = tdscm.forward(tobs, tdo, noise=noise,
                            do_mask={k: torch.from_numpy(v) for k, v in masks.items()})
    np.testing.assert_allclose(nhwc(out["cfs"]["x"]), np.asarray(ref["cfs"]["x"]), atol=1e-4)
    for k in ("thickness", "intensity", "digit"):
        np.testing.assert_allclose(_np(out["cfs"][k]), np.asarray(ref["cfs"][k]), atol=1e-4)
    for k in ("elbo", "nll", "kl", "aux_loss", "loss"):
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
    for pat in pats:
        idx = [i for i, r in enumerate(rows) if r == pat]
        with torch.no_grad():
            sparse = tdscm.forward({k: v[idx] for k, v in tobs.items()},
                                   {k: tdo[k][idx] for k in pat},
                                   noise=[e[idx] for e in noise])
        np.testing.assert_allclose(_np(out["cfs"]["x"][idx]), _np(sparse["cfs"]["x"]),
                                   atol=1e-5, err_msg=str(pat))
