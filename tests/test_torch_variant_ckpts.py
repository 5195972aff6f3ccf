"""The committed checkpoints of this slice's HVAE variants through the port, at
bs 1, against the JAX package on the CPU:

- ``checkpoints/final_morpho_cp``: Morpho-MNIST, ``cond_prior`` with
  ``cond_drop_from`` 2, float32, the mixture abduction at alpha 0.65;
- ``checkpoints/vol3d``: ``vol3d32`` (3-D, light blocks, trained in bf16;
  its config only in ``checkpoint.meta.json``), in bf16 and float32.

Each config reads from the checkpoint's ``.meta.json`` as JAX reads it, and
each EMA tree converts (5-D kernels, r^3 biases) and loads with
``strict=True``. Then the HVAE counterfactual on both sides with the same
draws: the ELBO (``train=False``), the abduction, ``forward_latents`` under
the parents and under the counterfactual ones (do(thickness), do(radius)),
and the transfer cf_x = clip(cf_loc + cf_scale u, -1, 1),
u = (x - rec_loc) / rec_scale, as ``DSCM.forward`` makes it.

Tolerances as tests/torch_parity.py::flagship_forward_check holds the
flagships: float32 the ELBO terms 1e-4 rel, cf_x 1e-4 abs, latents 1e-4
abs + rel (final_morpho_cp's mixture latents reach ~500 where a trained
posterior scale is tiny: u = (z - q_loc) / q_scale); bf16
the ELBO terms 2e-2 rel, latents within 2^-4 of their scale, cf_x within
the transfer's bound from the port's own decodes
(chip_smoke.ukbb_transfer_bound's formula). The NLL goes through one
function on both sides (torch_parity.patch_jax_nll_with_port).
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.train.checkpoint import load_checkpoint
from causal_gen_tpu_torch.convert import config_from_hparams, params_from_jax, unstack_decoder
from causal_gen_tpu_torch.data.datasets import VOL3D_MIN_MAX, make_vol3d
from causal_gen_tpu_torch.models.hvae import HVAE
from causal_gen_tpu_torch.utils.normalization import normalize

from tests.test_torch_ukbb import BF16_SCALE_TOL
from tests.torch_parity import nchw, nhwc, patch_jax_nll_with_port, patch_jax_noise, to_numpy

torch.set_num_threads(1)

CKPT = pathlib.Path(__file__).resolve().parent.parent / "checkpoints"
ALPHA = 0.65


@functools.cache
def _restored(name):
    jcfg, state, _ = load_checkpoint(str(CKPT / name / "checkpoint"))
    return jcfg, unstack_decoder(to_numpy(state.ema_params))


def _pair(name, dtype):
    jcfg, tree = _restored(name)
    # vol3d has no hparams.json: its .meta.json holds the config
    tcfg = config_from_hparams(str(CKPT / name / "checkpoint.meta.json"))
    assert tcfg.to_dict() == jcfg.to_dict()
    tcfg = tcfg.replace(dtype=dtype)
    tvae = HVAE(tcfg, device="cpu")
    tvae.load_state_dict(params_from_jax(tree), strict=True)
    return JHVAE(cfg=jcfg.replace(dtype=dtype, stage_scan=False)), tree, tvae


def _obs(name):
    """x in [-1, 1], the parents and the counterfactual ones."""
    if name == "vol3d":  # a sphere of the training distribution
        vols, raw = make_vol3d(1, 32, seed=0)
        x = (vols.astype(np.float32) - 127.5) / 127.5
        pa = np.stack([normalize(raw[k], *VOL3D_MIN_MAX[k]) for k in ("radius", "intensity")],
                      axis=1).astype(np.float32)
        cf = pa.copy()
        cf[:, 0] = 0.6  # do(radius)
        return x, pa, cf
    # a ring, as a "0" is drawn: on uniform noise the trained posterior's
    # log-scales overflow (exp(111) at block 4) and both packages give NaN
    yy, xx = np.mgrid[:32, :32]
    ring = np.sqrt((yy - 15.5) ** 2 + (1.4 * (xx - 15.5)) ** 2)
    x = (2 * np.clip(1.5 - np.abs(ring - 8), 0, 1) - 1)[None, :, :, None].astype(np.float32)
    pa = np.concatenate([[[-0.3, 0.2]], np.eye(10)[[4]]], axis=1).astype(np.float32)
    cf = pa.copy()
    cf[:, 0] = 0.7  # do(thickness)
    return x, pa, cf


def _counterfactual(abduct, decode, x, pa, cf):
    zs = abduct()
    zs = [z["z"] if isinstance(z, dict) else z for z in zs]
    cf_loc, cf_scale = decode(zs, cf)
    rec_loc, rec_scale = decode(zs, pa)
    return zs, cf_loc, cf_scale, rec_loc, rec_scale


@pytest.mark.parametrize("name,dtype", [("final_morpho_cp", "float32"), ("vol3d", "float32"),
                                        ("vol3d", "bfloat16")])
def test_committed_checkpoint_matches_jax(monkeypatch, name, dtype):
    bf16 = dtype == "bfloat16"
    jvae, tree, tvae = _pair(name, dtype)
    mixture = tvae.cfg.cond_prior
    x, pa, cf = _obs(name)
    rec = patch_jax_noise(monkeypatch, seed=21)
    patch_jax_nll_with_port(monkeypatch)

    def jax_side(p, x, pa, cf):
        def apply(*a, **k):
            return jvae.apply({"params": p}, *a, rngs={"sample": jax.random.PRNGKey(1)}, **k)

        out = apply(x, pa, beta=1.0, train=False)
        abd = (lambda: apply(x, pa, cf, ALPHA, method=jvae.abduct)) if mixture else (
            lambda: apply(x, pa, method=jvae.abduct))
        zs, cf_loc, cf_scale, rec_loc, rec_scale = _counterfactual(
            abd, lambda zs, q: apply(zs, q, method=jvae.forward_latents), x, pa, cf)
        u = (x - rec_loc) / jnp.clip(rec_scale, min=1e-12)
        return out, zs, jnp.clip(cf_loc + cf_scale * u, -1.0, 1.0)

    ref, jzs, jcf = jax.jit(jax_side)(tree, *map(jnp.asarray, (x, pa, cf)))
    n = len(jzs)
    draws = rec.torch_noise()
    assert len(draws) == (3 if mixture else 2) * n
    tx, tpa, tcf = nchw(x), torch.from_numpy(pa), torch.from_numpy(cf)
    with torch.no_grad():
        out = tvae(tx, tpa, beta=1.0, noise=iter(draws[:n]), train=False)
        abd = (lambda: tvae.abduct(tx, tpa, tcf, ALPHA, noise=iter(draws[n:]))) if mixture \
            else (lambda: tvae.abduct(tx, tpa, noise=iter(draws[n:])))
        zs, cf_loc, cf_scale, rec_loc, rec_scale = _counterfactual(
            abd, lambda zs, q: tvae.forward_latents(zs, q), tx, tpa, tcf)
        u = (tx - rec_loc) / torch.clamp(rec_scale, min=1e-12)
        cf_x = torch.clamp(cf_loc + cf_scale * u, -1.0, 1.0)
    rtol = 2e-2 if bf16 else 1e-4
    for k in ("elbo", "nll", "kl"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=rtol, err_msg=k)
    for i, (a, b) in enumerate(zip(zs, jzs)):
        b = np.asarray(b)
        tol = BF16_SCALE_TOL * max(1.0, np.abs(b).max()) if bf16 else 1e-4 * (1 + np.abs(b))
        assert (np.abs(nhwc(a) - b) <= tol).all(), (i, np.abs(nhwc(a) - b).max())
    err = (cf_x - nchw(np.asarray(jcf))).abs()
    limit = (BF16_SCALE_TOL * (1 + 2 * (cf_scale * u).abs() + cf_scale / rec_scale) if bf16
             else torch.full_like(err, 1e-4))
    print(f"\n{name} {dtype}: " + ", ".join(
        f"{k} port {float(out[k]):.6g} jax {float(ref[k]):.6g}" for k in ("elbo", "nll", "kl"))
          + f"; cf_x max err {err.max().item():.3g} ({(err / limit).max().item():.3g} of the "
          f"limit)")
    assert (err <= limit).all(), (err / limit).max().item()
