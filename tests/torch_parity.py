"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

The same inputs, made by numpy from a seed, go through a JAX function and its
counterpart in ``causal_gen_tpu_torch``. Parameters come from the flax
module's ``init`` and are converted with ``causal_gen_tpu_torch.convert``.
Noise reaches the JAX HVAE through a patched ``sample_gaussian`` that draws
from a seeded numpy queue and records each draw in order; the recorded draws
then go into the port as ``noise=``. The heads' own draws are caught the same
way: DGaussNet's normal through a patched ``jax.random.normal``, and the DMoL
sampler's key, from which ``jax_dmol_uniforms`` rebuilds its two uniform
draws; the Gumbel-Max posterior's through a patched ``jax.random.gumbel``.

``flax_checkpoint_numpy`` restores a committed Orbax checkpoint (the JAX
side of a conversion: the port cannot read Orbax), and ``flagship_dscm_pair``
holds a whole committed DSCM on both sides.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.train.state import init_train_state as jinit_state
from causal_gen_tpu.train.vae_trainer import _make_step_body, init_model_params
from causal_gen_tpu_torch.convert import params_from_jax
from causal_gen_tpu_torch.models.hvae import HVAE, plan_decoder_blocks
from causal_gen_tpu_torch.train.state import init_train_state
from causal_gen_tpu_torch.train.vae_trainer import train_step


def to_numpy(tree: Any) -> Any:
    """A flax parameter tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def load_jax_params(module: torch.nn.Module, tree: Any, allow_missing: str = None) -> None:
    """Load a flax tree into ``module``; a key the tree lacks must start with
    ``allow_missing`` (flax creates a submodule's params only when it runs)."""
    missing, unexpected = module.load_state_dict(params_from_jax(to_numpy(tree)), strict=False)
    assert not unexpected, unexpected
    assert all(allow_missing and k.startswith(allow_missing) for k in missing), missing


def nchw(a) -> torch.Tensor:
    """N(D)HWC array -> NC(D)HW float32 tensor."""
    a = np.asarray(a, np.float32)
    return torch.tensor(a.transpose(0, a.ndim - 1, *range(1, a.ndim - 1)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NC(D)HW tensor -> N(D)HWC numpy array."""
    return t.detach().cpu().numpy().transpose(0, *range(2, t.dim()), 1)


def small_morpho_cfg(jax_side: bool, res: int = 16, **overrides):
    """The small Morpho-MNIST config of tests/test_dscm.py::build_dscm."""
    if jax_side:
        from causal_gen_tpu.config import get_config
    else:
        from causal_gen_tpu_torch.config import get_config
    return get_config(
        "morphomnist", bs=8, input_res=res,
        enc_arch=f"{res}b1d2,{res // 2}b1d2,{res // 4}b1d4,1b1",
        dec_arch=f"1b1,{res // 4}b1,{res // 2}b1,{res}b1",
        widths=(8, 8, 16, 16), z_dim=4, bias_max_res=res, **overrides,
    )


class NoiseRecorder:
    """Replacement for ``causal_gen_tpu.models.hvae.sample_gaussian``: draws eps
    from a seeded numpy stream and records it (NHWC) in draw order."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.draws: List[np.ndarray] = []

    def __call__(self, key, loc, logscale):
        eps = self.rng.standard_normal(loc.shape).astype(np.float32)
        self.draws.append(eps)
        return loc + jnp.exp(logscale) * jnp.asarray(eps)

    def torch_noise(self) -> List[torch.Tensor]:
        return [nchw(e) for e in self.draws]


def patch_jax_noise(monkeypatch, seed: int) -> NoiseRecorder:
    import causal_gen_tpu.models.hvae as jax_hvae

    rec = NoiseRecorder(seed)
    monkeypatch.setattr(jax_hvae, "sample_gaussian", rec)
    return rec


def synth_batch(res: int, n: int, seed: int) -> Dict[str, np.ndarray]:
    """Synthetic Morpho-MNIST batch (NHWC x in [-1, 1])."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.uniform(-1, 1, (n, res, res, 1)).astype(np.float32),
        "thickness": rng.uniform(-0.8, 0.8, (n, 1)).astype(np.float32),
        "intensity": rng.uniform(-0.8, 0.8, (n, 1)).astype(np.float32),
        "digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)],
    }


def jax_batch(b: Dict[str, np.ndarray]) -> Dict[str, jax.Array]:
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: nchw(v) if k == "x" else torch.from_numpy(v) for k, v in b.items()}


class DropOption:
    """Replacement for ``jax.random.randint`` in the JAX decoder's
    conditioning dropout (``_drop_cond``): every draw is ``self.option``,
    read through a host callback when the program runs, so one compiled step
    takes a new option each call."""

    def __init__(self, option: int = 0):
        self.option = option

    def __call__(self, key, shape, minval, maxval, *a, **k):
        return jax.pure_callback(lambda: np.full(shape, self.option, np.int32),
                                 jax.ShapeDtypeStruct(shape, jnp.int32))


def patch_jax_drop_option(monkeypatch, option: int = 0) -> DropOption:
    drop = DropOption(option)
    monkeypatch.setattr(jax.random, "randint", drop)
    return drop


def random_jax_params(jvae, cfg, seed: int = 0):
    """A parameter tree for the JAX HVAE ``jvae`` of ``cfg`` without running
    its init: the shapes from ``jax.eval_shape`` of the init (seconds, where
    compiling the init takes tens), each leaf drawn from a seeded numpy
    stream: a kernel N(0, 1 / fan_in), every other leaf 0.05 N(0, 1). No
    leaf is zero, so every path, the parents' way into a conditional prior
    included, carries signal."""
    x = jnp.zeros((1,) + (cfg.input_res,) * cfg.spatial_dims + (cfg.input_channels,))
    pa = jnp.zeros((1, cfg.context_dim))
    shapes = jax.eval_shape(lambda k: jvae.init({"params": k, "sample": k}, x, pa,
                                                beta=cfg.beta, train=False)["params"],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        std = (1.0 / np.sqrt(np.prod(s.shape[:-1])) if path[-1].key.endswith("kernel")
               else 0.05)
        return jnp.asarray((std * rng.standard_normal(s.shape)).astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def run_steps_against_jax(jcfg, tcfg, channels, context_dim, monkeypatch, n_steps=4,
                          nan_step=2, options=None, params=None):
    """``n_steps`` train steps of both packages from converted parameters, on
    the same uint8 batches (accu_steps microbatches each) and noise. Step
    ``nan_step`` has a NaN parent, so both skip it. Returns the per-step
    metrics of both and the two final states. ``options[s]`` forces a
    ``cond_prior`` model's dropout option of step s on both sides (the port
    takes it first in each microbatch's draws); ``params`` replaces the
    initial parameters.

    The JAX step is jitted: its patched sample_gaussian draws once, at trace
    time, and the compiled step reuses those draws for every microbatch and
    every step, so the port is fed the same draws each time."""
    jvae = JHVAE(cfg=jcfg)
    if params is None:
        params = init_model_params(jcfg, jvae, jax.random.PRNGKey(0))
    jstate = jinit_state(jcfg, params)
    tvae = HVAE(tcfg, device="cpu")
    load_jax_params(tvae, params)
    tstate = init_train_state(tcfg, tvae)
    rec = patch_jax_noise(monkeypatch, seed=5)
    drop = None if options is None else patch_jax_drop_option(monkeypatch)
    jstep = jax.jit(_make_step_body(jcfg, jvae))
    n_stochastic = sum(1 for r, _ in plan_decoder_blocks(tcfg) if r <= tcfg.z_max_res)
    accu, res = jcfg.accu_steps, jcfg.input_res
    micro = jcfg.bs // accu
    space = (res,) * jcfg.spatial_dims
    rng = np.random.default_rng(0)
    metrics = []
    for s in range(n_steps):
        x = rng.integers(0, 256, (accu, micro) + space + (channels,)).astype(np.uint8)
        pa = rng.uniform(-1, 1, (accu, micro, context_dim)).astype(np.float32)
        if s == nan_step:
            pa[0, 0, 0] = np.nan
        head = []
        if drop is not None:
            drop.option = options[s]
            head = [torch.tensor(options[s])]
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "pa": jnp.asarray(pa)},
                           jax.random.PRNGKey(s))
        assert len(rec.draws) == n_stochastic  # one trace, one draw per stochastic block
        noise = [head + rec.torch_noise() for _ in range(accu)]
        batch = {"x": torch.from_numpy(x.reshape((accu * micro,) + space + (channels,)))
                 .permute(0, len(space) + 1, *range(1, len(space) + 1)).contiguous(),
                 "pa": torch.from_numpy(pa.reshape(accu * micro, context_dim))}
        tm = train_step(tcfg, tstate, batch, noise=noise)
        metrics.append(({k: float(v) for k, v in jax.device_get(jm).items()},
                        {k: float(v) for k, v in tm.items()}))
    return metrics, jstate, tstate


def assert_states_match(metrics, jstate, tstate, atol=1e-5):
    for s, (jm, tm) in enumerate(metrics):
        assert jm["skipped"] == tm["skipped"], s
        for k in ("elbo", "nll", "kl", "grad_norm"):
            if np.isnan(jm[k]):
                assert np.isnan(tm[k]), (s, k)
            else:
                assert tm[k] == pytest.approx(jm[k], rel=1e-4), (s, k, tm[k], jm[k])
    assert (tstate.step, tstate.skipped, tstate.ema_updates) == (
        int(jstate.step), int(jstate.skipped), int(jstate.ema_updates))
    for tree, module in ((jstate.params, tstate.model), (jstate.ema_params, tstate.ema)):
        ref = params_from_jax(to_numpy(tree))
        got = module.state_dict()
        assert sorted(ref) == sorted(got)
        errs = {k: (got[k] - ref[k]).abs() for k in ref}
        worst_key = max(errs, key=lambda k: errs[k].max())
        n_over = sum(int((e > atol).sum()) for e in errs.values())
        assert n_over == 0, (f"{n_over} elements differ by more than {atol}; worst "
                             f"{errs[worst_key].max().item():.3e} in {worst_key}")


def patch_jax_nll_with_port(monkeypatch) -> None:
    """Have the JAX DGaussNet evaluate its NLL, and the NLL's gradient, with
    the port's function.

    XLA's float32 tanh on the CPU is off by several ulp near 1, PyTorch's by
    at most one, and the discretized-Gaussian NLL of a pixel in the far tail
    is a difference of two CDFs near 1 that carries only a few ulp: there the
    two packages differ by up to several nats per pixel. The tests that
    compare NLL-dependent outputs (ELBO, DSCM loss, train steps) therefore
    feed the JAX model's (loc, logscale) through one NLL evaluation, and its
    cotangent through that evaluation's autograd; the mismatch itself is
    shown by test_torch_sample_kl.py::test_dgauss_nll_tail_follows_tanh_ulps.
    """
    import causal_gen_tpu.models.likelihoods as jax_lik
    from causal_gen_tpu_torch.ops.distributions import discretized_gaussian_nll

    def tensors(*arrays):
        return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]

    def value(loc, logscale, x):
        with torch.no_grad():
            return discretized_gaussian_nll(*tensors(loc, logscale, x)).numpy()

    def cotangents(loc, logscale, x, g):
        loc, logscale, x, g = tensors(loc, logscale, x, g)
        loc.requires_grad_()
        logscale.requires_grad_()
        out = discretized_gaussian_nll(loc, logscale, x)
        return tuple(t.numpy() for t in torch.autograd.grad(out, (loc, logscale), g))

    @jax.custom_vjp
    def nll(loc, logscale, x):
        return jax.pure_callback(value, jax.ShapeDtypeStruct(loc.shape[:1], jnp.float32),
                                 loc, logscale, x)

    def nll_fwd(loc, logscale, x):
        return nll(loc, logscale, x), (loc, logscale, x)

    def nll_bwd(res, g):
        loc, logscale, x = res
        shapes = tuple(jax.ShapeDtypeStruct(a.shape, jnp.float32) for a in (loc, logscale))
        d_loc, d_logscale = jax.pure_callback(cotangents, shapes, loc, logscale, x, g)
        return d_loc, d_logscale, jnp.zeros_like(x)

    nll.defvjp(nll_fwd, nll_bwd)
    monkeypatch.setattr(jax_lik, "discretized_gaussian_nll", nll)


def jax_dmol_uniforms(key, b: int, h: int, w: int, nr_mix: int = 10):
    """The two uniform draws of ``causal_gen_tpu.ops.dmol.
    sample_from_discretized_mix_logistic`` under ``key``, as NCHW tensors
    (u_mix (B,K,H,W), u (B,3,H,W)), made as that function makes them."""
    k_mix, k_u = jax.random.split(key)
    eps = jax.random.uniform(k_mix, (b, h, w, nr_mix), minval=1e-5, maxval=1.0 - 1e-5)
    u = jax.random.uniform(k_u, (b, h, w, 3), minval=1e-5, maxval=1.0 - 1e-5)
    return nchw(eps), nchw(u)


class HeadDrawRecorder:
    """Catches the draws of the JAX heads' ``sample(return_loc=False)``:
    DGaussNet's standard normal (drawn here from a seeded numpy stream) and the
    DMoL sampler's key (its uniforms rebuilt by ``jax_dmol_uniforms``). Each
    draw is kept in the form the port's head takes it."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.draws: List[Any] = []

    def normal(self, key, shape, dtype=jnp.float32):
        eps = self.rng.standard_normal(shape).astype(np.float32)
        self.draws.append(nchw(eps))
        return jnp.asarray(eps, dtype)

    def dmol_sampler(self, original):
        def sample(key, l, nr_mix, t=None):
            b, h, w, _ = l.shape
            self.draws.append(jax_dmol_uniforms(key, b, h, w, nr_mix))
            return original(key, l, nr_mix, t=t)
        return sample


def patch_jax_head_draws(monkeypatch, seed: int) -> HeadDrawRecorder:
    import causal_gen_tpu.ops.dmol as jax_dmol

    rec = HeadDrawRecorder(seed)
    monkeypatch.setattr(jax.random, "normal", rec.normal)
    monkeypatch.setattr(jax_dmol, "sample_from_discretized_mix_logistic",
                        rec.dmol_sampler(jax_dmol.sample_from_discretized_mix_logistic))
    return rec


def flax_checkpoint_numpy(path: str, kind: str) -> Dict[str, Any]:
    """The EMA parameters of a committed checkpoint as a tree of numpy arrays,
    restored read-only through the JAX package: ``kind`` "vae" through
    ``causal_gen_tpu.train.checkpoint.load_checkpoint``, "pgm" or "aux"
    through ``causal_gen_tpu.pgm.train_pgm.load_pgm_checkpoint``; "cf" gives
    a CF checkpoint's whole state (``causal_gen_tpu.pgm.train_cf.
    cf_state_payload``: both trainable trees, both optax states as Orbax
    restores them without a template, the counters), which
    ``causal_gen_tpu_torch.convert.cf_state_from_jax`` reads. With
    ``causal_gen_tpu_torch.convert.save_converted`` it makes the file that
    ``load_converted`` reads on the card."""
    if kind == "vae":
        from causal_gen_tpu.train.checkpoint import load_checkpoint

        _, state, _ = load_checkpoint(path)
    elif kind in ("pgm", "aux"):
        from causal_gen_tpu.pgm.train_pgm import load_pgm_checkpoint

        _, state, _ = load_pgm_checkpoint(path)
    elif kind == "cf":
        import orbax.checkpoint as ocp

        return _numpy_tree(ocp.PyTreeCheckpointer().restore(os.path.abspath(path)))
    else:
        raise ValueError(f"kind {kind!r} is none of vae, pgm, aux, cf")
    return to_numpy(state.ema_params)


def _numpy_tree(tree: Any) -> Any:
    """An Orbax restore without a template (dicts, lists, None, ints and
    arrays) with every array as numpy."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    if tree is None or isinstance(tree, (int, float)):
        return tree
    return np.asarray(tree)


class GumbelRecorder:
    """Replacement for ``jax.random.gumbel``: standard-Gumbel draws from a
    seeded numpy stream, recorded in draw order."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.draws: List[np.ndarray] = []

    def __call__(self, key, shape=(), dtype=jnp.float32, *a, **k):
        self.draws.append(self.rng.gumbel(size=shape).astype(np.float32))
        return jnp.asarray(self.draws[-1], dtype)

    def torch_draws(self) -> List[torch.Tensor]:
        return [torch.from_numpy(d) for d in self.draws]


def patch_jax_gumbel(monkeypatch, seed: int) -> GumbelRecorder:
    rec = GumbelRecorder(seed)
    monkeypatch.setattr(jax.random, "gumbel", rec)
    return rec


def dscm_checkpoint_paths(ckpt_dir) -> Dict[str, str]:
    """{vae, pgm, aux} -> checkpoint path of a committed DSCM: ``ckpt_dir``
    is a directory holding ``{vae,pgm,aux}/checkpoint`` (the flagships), or
    the three paths in that order (Colour-MNIST's, trained apart)."""
    if isinstance(ckpt_dir, tuple):
        return dict(zip(("vae", "pgm", "aux"), ckpt_dir))
    return {k: f"{ckpt_dir}/{k}/checkpoint" for k in ("vae", "pgm", "aux")}


def vae_config_path(path: str) -> str:
    """The file holding an HVAE checkpoint's config: its ``.meta.json``,
    or the run's ``hparams.json`` where the meta is not committed
    (``checkpoints/cmnist/final_cmnist``: .gitignore keeps its ``step_*``
    files out but the restored tree)."""
    import os

    meta = path + ".meta.json"
    return meta if os.path.exists(meta) else os.path.join(os.path.dirname(path), "hparams.json")


def load_vae_checkpoint(path: str):
    """``causal_gen_tpu.train.checkpoint.load_checkpoint``, or where the
    checkpoint's ``.meta.json`` is not committed, the Orbax tree restored
    with the config of the run's ``hparams.json`` and, as the best ELBO, the
    lowest metric of its ``index.json``."""
    import json
    import os
    import types

    from causal_gen_tpu.config import Config
    from causal_gen_tpu.train.checkpoint import load_checkpoint

    if os.path.exists(path + ".meta.json"):
        return load_checkpoint(path)
    import orbax.checkpoint as ocp

    run = os.path.dirname(path)
    with open(os.path.join(run, "hparams.json")) as f:
        cfg = Config.from_dict(json.load(f))
    with open(os.path.join(run, "index.json")) as f:
        best = min(e["metric"] for e in json.load(f)["entries"])
    payload = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))
    return cfg, types.SimpleNamespace(ema_params=payload["ema_params"]), {"best_loss": best}


@functools.cache
def _flagship_checkpoints(ckpt_dir):
    """A committed DSCM's three checkpoints (``dscm_checkpoint_paths``),
    restored once: the HVAE's config, the flax PGM and
    predictor, the EMA trees (numpy; the decoder unstacked), the
    ``checkpoint_meta`` of each and the HVAE's best ELBO."""
    from causal_gen_tpu.cli.train_cf import build_pgm_from_ckpt
    from causal_gen_tpu_torch.convert import checkpoint_meta, unstack_decoder

    paths = dscm_checkpoint_paths(ckpt_dir)
    jcfg, vstate, extra = load_vae_checkpoint(paths["vae"])
    _, jpgm, pstate = build_pgm_from_ckpt(paths["pgm"], False)
    _, jpred, astate = build_pgm_from_ckpt(paths["aux"], True)
    trees = {k: to_numpy(s.ema_params) for k, s in
             (("vae", vstate), ("pgm", pstate), ("aux", astate))}
    trees["vae"] = unstack_decoder(trees["vae"])
    metas = {k: checkpoint_meta(p) for k, p in paths.items() if k != "vae"}
    return jcfg, jpgm, jpred, trees, metas, float(extra.get("best_loss", 0.0))


@functools.cache
def flagship_dscm_pair(ckpt_dir, dtype: str):
    """A committed DSCM (``dscm_checkpoint_paths(ckpt_dir)``) on both
    sides in ``dtype``: the JAX DSCM as cli/train_cf.py builds it, with its
    trainable and frozen trees, and the port's DSCM on the CPU from the
    converted trees, loaded with ``strict=True``. The JAX HVAE runs unrolled
    (``stage_scan=False``, the tree through ``unstack_decoder``): a scanned
    run traces its body once, so a patched draw would serve every block of
    the run."""
    from causal_gen_tpu.pgm.dscm import DSCM as JDSCM
    from causal_gen_tpu_torch.convert import build_dscm, config_from_hparams, dscm_state_dicts

    jcfg, jpgm, jpred, trees, metas, eps = _flagship_checkpoints(ckpt_dir)
    jcfg = jcfg.replace(dtype=dtype, stage_scan=False)
    jdscm = JDSCM(cfg=jcfg, pgm=jpgm, predictor=jpred, vae=JHVAE(cfg=jcfg),
                  elbo_constraint=eps)
    tcfg = config_from_hparams(vae_config_path(dscm_checkpoint_paths(ckpt_dir)["vae"]))
    tcfg = tcfg.replace(dtype=dtype)
    tdscm = build_dscm(tcfg, metas["pgm"]["config"], metas["aux"]["config"],
                       dscm_state_dicts(trees["vae"], trees["pgm"], trees["aux"]),
                       device="cpu", elbo_constraint=eps)
    frozen = {"pgm": trees["pgm"], "predictor": trees["aux"]}
    return jdscm, jdscm.init_trainable(trees["vae"]), frozen, tdscm


def jax_float64_forward(ckpt_dir, obs: Dict[str, np.ndarray], do: Dict[str, np.ndarray],
                        factual_only: bool = False) -> Dict[str, Any]:
    """The JAX package's DSCM.forward of a committed DSCM in float64, or with
    ``factual_only`` just its factual HVAE pass (elbo, nll, kl): the float32
    model of ``flagship_dscm_pair`` with its weights, ``obs`` and ``do`` as
    float64 under ``jax.enable_x64``, and its explicit float32 casts
    (``jnp.float32``) made float64 casts for the trace. It draws the same
    posterior normals and Gumbel-Max draws as ``flagship_forward_check`` (the
    same seeds, in the same order) and keeps the JAX package's own NLL. The
    exact result that the float32 and bf16 runs of either package
    approximate, computed by JAX code alone. It runs op by op
    (``jax.disable_jit``), which at bs 1 takes about half the time of
    compiling the float64 program. Returns numpy (float64)."""
    from causal_gen_tpu.pgm.dscm import vae_preprocess

    key = (ckpt_dir, factual_only) + tuple(
        (k, v.tobytes()) for d in (obs, do) for k, v in sorted(d.items()))
    if key not in _JAX_FLOAT64:
        jdscm, trainable, frozen, _ = flagship_dscm_pair(ckpt_dir, "float32")

        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64)
                if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)

        with pytest.MonkeyPatch.context() as m, jax.enable_x64(True), jax.disable_jit():
            m.setattr(jnp, "float32", jnp.float64)
            patch_jax_noise(m, seed=21)
            patch_jax_gumbel(m, seed=22)
            o, cfg = f64(obs), jdscm.cfg
            if factual_only:
                pa = vae_preprocess(cfg, {k: v for k, v in o.items() if k != "x"})
                out = jdscm.vae.apply({"params": f64(trainable)["vae"]}, o["x"], pa,
                                      beta=cfg.beta, train=False,
                                      rngs={"sample": jax.random.PRNGKey(0)})
            else:
                out = jdscm.forward(f64(trainable), f64(frozen), o, f64(do),
                                    jax.random.PRNGKey(0))
            _JAX_FLOAT64[key] = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), out)
    return _JAX_FLOAT64[key]


_JAX_FLOAT64: Dict[tuple, Dict[str, Any]] = {}


def flagship_forward_check(monkeypatch, ckpt_dir, dtype: str, obs: Dict[str, np.ndarray],
                           do: Dict[str, np.ndarray], past_limit: int = 0) -> None:
    """The port's DSCM.forward of a committed DSCM against the JAX package's
    on ``obs`` (NHWC x, PGM-space parents) under ``do``, with the same
    posterior normals and Gumbel-Max draws; the NLL through one function
    (``patch_jax_nll_with_port``).

    The counterfactual parents within 1e-5. float32: nll, elbo and aux_loss
    within 1e-4 rel, cf_x within 1e-4 abs. bf16: nll and elbo within 2e-2
    rel, aux_loss within 2^-4 rel, cf_x within the pixel-noise transfer
    bound of tests/test_torch_ukbb_dscm.py (eps 2^-4, from the port's own
    decodes; chip_smoke.ukbb_transfer_bound). The KL of a trained posterior
    that sits on its prior in most blocks is a sum of ~10^6 elements that
    each cancel terms of order 1, so it is held to its tolerance plus the
    JAX run's own distance from the JAX package's float64 run
    (``jax_float64_forward``), a slack no port code enters.

    ``past_limit`` is the documented case of ROADMAP Queue 3 (the ukbb192
    flagship): as many cf_x pixels may lie past their limit, since the
    transfer cf_x = cf_loc + cf_scale u, u = (x - rec_loc) / rec_scale,
    multiplies the decoders' rounding where rec_scale is small, in either
    package. The port must then also be as accurate as the JAX package
    against the float64 run (there the whole forward; elsewhere its factual
    pass, for the KL): its error at the median, the 90th and 99th
    percentile, the maximum and in the mean at most 1.25 times the JAX
    run's + 2^-8 (bf16) or + 1e-6 (float32).
    It prints what it measured (pytest -s).
    """
    from chip_smoke import ukbb_transfer_bound

    ref64 = jax_float64_forward(ckpt_dir, obs, do, factual_only=not past_limit)
    jdscm, trainable, frozen, tdscm = flagship_dscm_pair(ckpt_dir, dtype)
    rec = patch_jax_noise(monkeypatch, seed=21)
    gum = patch_jax_gumbel(monkeypatch, seed=22)
    patch_jax_nll_with_port(monkeypatch)
    ref = jax.jit(lambda *a: jdscm.forward(*a, jax.random.PRNGKey(0)))(
        trainable, frozen, {k: jnp.asarray(v) for k, v in obs.items()},
        {k: jnp.asarray(v) for k, v in do.items()})
    n_sto = len(rec.draws) // 2  # the factual pass's, then the abduction's
    normals = rec.torch_noise()
    noise = normals[:n_sto] + gum.torch_draws() + normals[n_sto:]
    tobs = {k: nchw(v) if k == "x" else torch.from_numpy(v) for k, v in obs.items()}
    tdo = {k: torch.from_numpy(v) for k, v in do.items()}
    with torch.no_grad():
        out = tdscm.forward(tobs, tdo, noise=noise)
    bf16 = dtype == "bfloat16"
    if bf16:
        with torch.no_grad():
            limit = ukbb_transfer_bound(tdscm, tobs, out, normals[n_sto:]).double()
    for k in out["cfs"]:
        if k != "x":
            np.testing.assert_allclose(out["cfs"][k].numpy(), np.asarray(ref["cfs"][k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    rtol = 2e-2 if bf16 else 1e-4
    for k in ("elbo", "nll"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=rtol, err_msg=k)
    jax_kl_err = abs(float(ref["kl"]) - float(ref64["kl"]))
    assert abs(float(out["kl"]) - float(ref["kl"])) <= rtol * abs(float(ref["kl"])) + jax_kl_err, (
        float(out["kl"]), float(ref["kl"]), float(ref64["kl"]))
    np.testing.assert_allclose(float(out["aux_loss"]), float(ref["aux_loss"]),
                               rtol=2.0 ** -4 if bf16 else 1e-4, err_msg="aux_loss")
    jcf = nchw(np.asarray(ref["cfs"]["x"])).double()
    diff = (out["cfs"]["x"].double() - jcf).abs()
    if not bf16:
        limit = torch.full_like(diff, 1e-4)
    over = diff > limit
    print(f"\n{ckpt_dir} {dtype}: " + ", ".join(
        f"{k} port {float(out[k]):.6g} jax {float(ref[k]):.6g}"
        + (f" jax float64 {float(ref64[k]):.6g}" if k in ref64 else "")
        for k in ("elbo", "nll", "kl", "aux_loss")) +
        f"; cf_x |port - jax| max {diff.max().item():.3g} mean {diff.mean().item():.3g}, "
        f"{int(over.sum())} of {diff.numel()} pixels past the limit (max "
        f"{(diff / limit).max().item():.3g} of it)")
    assert int(over.sum()) <= past_limit, (int(over.sum()), (diff / limit).max().item())
    if not past_limit:
        return
    cf64 = nchw(ref64["cfs"]["x"]).double()
    port_err, jax_err = (out["cfs"]["x"].double() - cf64).abs(), (jcf - cf64).abs()
    print(f"JAX's own error at those pixels max "
          f"{jax_err[over].max().item() if over.any() else 0:.3g}; against JAX "
          f"float64 (pixels past the limit, max, mean, p99): port "
          f"{int((port_err > limit).sum())}, {port_err.max().item():.3g}, "
          f"{port_err.mean().item():.3g}, {port_err.flatten().quantile(0.99).item():.3g}; jax "
          f"{int((jax_err > limit).sum())}, {jax_err.max().item():.3g}, "
          f"{jax_err.mean().item():.3g}, {jax_err.flatten().quantile(0.99).item():.3g}")
    for q in (0.5, 0.9, 0.99, 1.0, None):
        p, j = ((e.mean() if q is None else e.flatten().quantile(q)).item()
                for e in (port_err, jax_err))
        assert p <= 1.25 * j + (2.0 ** -8 if bf16 else 1e-6), (q, p, j)


def synth_pgm_obs(dataset: str, n: int, res: int, seed: int) -> Dict[str, np.ndarray]:
    """A batch of a dataset's PGM variables in PGM space (binary 0/1 (n, 1),
    continuous in (-0.8, 0.8), one-hots) and an NHWC image in [-1, 1]."""
    rng = np.random.default_rng(seed)
    cont = lambda: rng.uniform(-0.8, 0.8, (n, 1)).astype(np.float32)  # noqa: E731
    binary = lambda: rng.integers(0, 2, (n, 1)).astype(np.float32)  # noqa: E731
    onehot = lambda k: np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]  # noqa: E731
    if dataset == "morphomnist":
        obs = {"thickness": cont(), "intensity": cont(), "digit": onehot(10)}
    elif dataset == "cmnist":
        obs = {"digit": onehot(10), "colour": onehot(10)}
    elif dataset == "ukbb":
        obs = {"sex": binary(), "mri_seq": binary(), "age": cont(), "brain_volume": cont(),
               "ventricle_volume": cont()}
    elif dataset == "mimic":
        obs = {"sex": binary(), "age": cont(), "race": onehot(3), "finding": binary()}
    else:
        raise KeyError(dataset)
    channels = 3 if dataset == "cmnist" else 1
    obs["x"] = rng.uniform(-1, 1, (n, res, res, channels)).astype(np.float32)
    return obs


def pgm_pair(dataset: str, role: str, res: int = 32, seed: int = 0, n: int = 6):
    """A dataset's PGM on both sides with the same random parameters: the
    flax module and its numpy tree, the port's module (CPU) loaded from it,
    and a batch from ``synth_pgm_obs``. ``role``: "pgm" (the SCM's nets, as
    sup_pgm initialises it), "aux" (the predictors, as sup_aux initialises
    them) or "semi" (both, as semi_sup's ``init_all``). Every leaf is drawn
    anew from a seeded stream (kernels N(0, 1/fan_in), the rest their init
    + 0.5 N(0, 1)), so no zero-initialised logit, spline or bias hides a
    path. Each role's module loads its tree with ``strict=True``."""
    from causal_gen_tpu.pgm.flow_pgm import PGM_REGISTRY as JREG
    from causal_gen_tpu_torch.pgm.flow_pgm import PGM_REGISTRY as TREG

    obs = synth_pgm_obs(dataset, n, res, seed)
    attrs = {k: jnp.asarray(v) for k, v in obs.items() if k != "x"}
    x = jnp.asarray(obs["x"])
    predictors = role != "pgm"
    kw = {"input_res": res} if dataset != "mimic" else {}
    jpgm = JREG[dataset](setup_predictors=predictors, **kw)
    key = jax.random.PRNGKey(seed)
    rngs = {"params": key, "sample": key, "dropout": key}
    if role == "pgm":
        tree = jpgm.init(rngs, attrs, method=jpgm.svi_logprob)["params"]
    elif role == "aux":
        tree = jpgm.init(rngs, x, method=jpgm.anticausal_logprob, **attrs)["params"]
    else:
        tree = jpgm.init(rngs, x, attrs, method=jpgm.init_all)["params"]
    rng = np.random.default_rng(seed + 1000)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "kernel":
            return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
                    ).astype(np.float32)
        return (a + 0.5 * rng.standard_normal(a.shape)).astype(np.float32)

    tree = to_numpy(jax.tree_util.tree_map_with_path(leaf, tree))
    extra = {"scm_nets": True} if role == "semi" and dataset != "cmnist" else {}
    tpgm = TREG[dataset](setup_predictors=predictors, device="cpu",
                         **({} if dataset == "mimic" else {"input_res": res}), **extra)
    tpgm.load_state_dict(params_from_jax(tree), strict=True)
    return jpgm, tree, tpgm, obs


class JaxDraws:
    """Replacements for ``jax.random.normal``, ``uniform``, ``gumbel`` and
    ``categorical``: standard normals, U[0, 1) draws, standard Gumbels and,
    for ``categorical``, argmax(logits + g) with g a standard Gumbel, all
    from one seeded numpy stream and recorded (numpy) in draw order. Under
    ``jax.jit`` they draw once, at trace time."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.draws: List[np.ndarray] = []

    def _keep(self, a, dtype=jnp.float32):
        self.draws.append(np.asarray(a, np.float32))
        return jnp.asarray(self.draws[-1], dtype)

    def normal(self, key, shape=(), dtype=jnp.float32, *a, **k):
        return self._keep(self.rng.standard_normal(shape), dtype)

    def uniform(self, key, shape=(), dtype=jnp.float32, *a, **k):
        return self._keep(self.rng.uniform(0.0, 1.0, shape), dtype)

    def gumbel(self, key, shape=(), dtype=jnp.float32, *a, **k):
        return self._keep(self.rng.gumbel(size=shape), dtype)

    def categorical(self, key, logits, axis=-1, shape=None):
        return jnp.argmax(logits + self._keep(self.rng.gumbel(size=logits.shape)), axis=axis)


def patch_jax_draws(monkeypatch, seed: int, *names: str) -> JaxDraws:
    """``JaxDraws`` in place of the ``jax.random`` functions ``names``."""
    rec = JaxDraws(seed)
    for name in names:
        monkeypatch.setattr(jax.random, name, getattr(rec, name))
    return rec


def small_dscm_pair(seed: int = 0, elbo_constraint: float = 1.8, **dscm_fields):
    """tests/test_dscm.py's small Morpho-MNIST DSCM (16^2) on both sides
    with the same seeded parameters, made from ``jax.eval_shape`` (seconds,
    where the flax inits take about a minute): the HVAE's as
    ``random_jax_params`` draws them, halved (at full size its decoded
    scales overflow on some images), the PGM's and the predictor's kernels
    N(0, 1 / fan_in), norm scales 1 + 0.1 N(0, 1), biases 0.05 N(0, 1) and
    the spline and digit logits N(0, 1). ``dscm_fields`` (the soft-morphometry weights, ``remat``) go to
    both DSCMs. Returns (JAX DSCM, its VAE tree, the frozen trees, the
    port's DSCM on the CPU)."""
    from causal_gen_tpu.pgm.dscm import DSCM as JDSCM
    from causal_gen_tpu.pgm.flow_pgm import MorphoMNISTPGM as JPGM
    from causal_gen_tpu_torch.pgm.dscm import DSCM
    from causal_gen_tpu_torch.pgm.flow_pgm import MorphoMNISTPGM

    jcfg, tcfg = small_morpho_cfg(True), small_morpho_cfg(False)
    jvae = JHVAE(cfg=jcfg)
    vae_params = random_jax_params(jvae, jcfg, seed=seed)
    jpgm = JPGM(setup_predictors=False)
    jpred = JPGM(setup_predictors=True, input_res=jcfg.input_res)
    n = 2
    attrs = {"thickness": jnp.zeros((n, 1)), "intensity": jnp.zeros((n, 1)),
             "digit": jnp.zeros((n, 10))}
    x = jnp.zeros((n, jcfg.input_res, jcfg.input_res, 1))
    key = jax.random.PRNGKey(0)
    shapes = {"pgm": jax.eval_shape(lambda k: jpgm.init({"params": k, "sample": k},
                                                       attrs)["params"], key),
              "predictor": jax.eval_shape(lambda k: jpred.init(
                  {"params": k, "sample": k}, x, method=jpred.anticausal_logprob,
                  **attrs)["params"], key)}
    rng = np.random.default_rng(seed + 100)

    def leaf(path, s):
        name = path[-1].key
        z = rng.standard_normal(s.shape)
        if name == "kernel":
            return (z / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return {"scale": 1.0 + 0.1 * z, "bias": 0.05 * z}.get(name, z).astype(np.float32)

    frozen = {k: to_numpy(jax.tree_util.tree_map_with_path(leaf, v)) for k, v in shapes.items()}
    vae_params = jax.tree_util.tree_map(lambda a: 0.5 * a, vae_params)
    jdscm = JDSCM(cfg=jcfg, pgm=jpgm, predictor=jpred, vae=jvae,
                  elbo_constraint=elbo_constraint, **dscm_fields)
    tvae = HVAE(tcfg, device="cpu")
    load_jax_params(tvae, vae_params)
    tpgm = MorphoMNISTPGM(setup_predictors=False, device="cpu")
    load_jax_params(tpgm, frozen["pgm"])
    tpred = MorphoMNISTPGM(setup_predictors=True, input_res=tcfg.input_res, device="cpu")
    tpred.load_state_dict(params_from_jax(frozen["predictor"]), strict=True)
    tdscm = DSCM(tcfg, tpgm, tpred, tvae, elbo_constraint=elbo_constraint, **dscm_fields)
    return jdscm, vae_params, frozen, tdscm
