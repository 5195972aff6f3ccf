"""Whole committed checkpoints through the port (causal_gen_tpu_torch/convert.py):
unstack_decoder against migrate_decoder_params on a small stage_scan config;
config_from_hparams on every committed hparams.json; the ukbb192 and mimic192
flagships' three trees converted and loaded with strict=True, through a
save_converted file; checkpoints/final_morpho2 (unrolled layout): the ELBO,
NLL and KL; the ukbb192 flagship's DSCM.forward at bs 1 in float32 and bf16
against the JAX package's on the same batch and injected noise. The mimic192
flagship's forward is in tests/test_torch_mimic_flagship.py.

Tolerances: the ELBO terms 1e-4 rel (final_morpho2); the flagships' as
torch_parity.flagship_forward_check states them.
"""

import functools
import inspect
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causal_gen_tpu.config import Config as JConfig
from causal_gen_tpu.config import get_config as jget
from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.models.hvae import migrate_decoder_params
from causal_gen_tpu.train.checkpoint import load_checkpoint
from causal_gen_tpu_torch.config import get_config as tget
from causal_gen_tpu_torch.convert import (
    PGM_FIELDS,
    checkpoint_meta,
    config_from_hparams,
    dscm_state_dicts,
    load_converted,
    params_from_jax,
    save_converted,
    unstack_decoder,
)
from causal_gen_tpu_torch.models.hvae import HVAE

from tests.torch_parity import (
    flagship_forward_check,
    flax_checkpoint_numpy,
    nchw,
    patch_jax_nll_with_port,
    patch_jax_noise,
    to_numpy,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints"
HPARAMS = sorted(CKPT.glob("**/hparams.json"))
ROLES = ("vae", "pgm", "aux")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def test_unstack_decoder_inverts_migrate_decoder_params():
    """A small config whose decoder has runs beside boundary blocks: the
    stacked tree migrate_decoder_params makes (the layout a stage_scan=True
    HVAE initialises to) unstacks to the unrolled tree, leaf for leaf, which
    the port's HVAE loads with strict=True."""
    kw = dict(bs=2, input_res=16, enc_arch="16b1d2,8b2d2,4b1d4,1b1",
              dec_arch="1b2,4b3,8b3,16b1", widths=(8, 8, 16, 16), z_dim=4, context_dim=12,
              bias_max_res=16)
    jcfg = jget("morphomnist", **kw)
    x, pa = jnp.zeros((1, 16, 16, 1)), jnp.zeros((1, 12))

    def init(cfg):
        model = JHVAE(cfg=cfg)
        return lambda k: model.init({"params": k, "sample": k}, x, pa, beta=1.0,
                                    train=False)["params"]

    flat = to_numpy(jax.jit(init(jcfg))(jax.random.PRNGKey(0)))
    stacked = to_numpy(migrate_decoder_params(jcfg.replace(stage_scan=True), flat))
    scanned_shapes = jax.eval_shape(init(jcfg.replace(stage_scan=True)), jax.random.PRNGKey(0))
    assert jax.tree.structure(scanned_shapes) == jax.tree.structure(stacked)
    assert any(k.startswith("run_") for k in stacked["decoder"])
    assert any(k.startswith("blocks_") for k in stacked["decoder"])
    back = unstack_decoder(stacked)
    a, b = dict(_leaves(back)), dict(_leaves(flat))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert unstack_decoder(flat) == flat  # an unrolled tree comes back as it is
    HVAE(tget("morphomnist", **kw), device="cpu").load_state_dict(params_from_jax(back),
                                                                  strict=True)


@pytest.mark.parametrize("path", HPARAMS, ids=lambda p: str(p.relative_to(CKPT)))
def test_config_from_hparams_reads_every_committed_hparams(path):
    """An HVAE's hparams.json gives the config the JAX package reads from it,
    JAX-only fields kept; a PGM's is refused (build_pgm takes it as a dict)."""
    d = json.loads(path.read_text())
    if "dataset" in d:
        with pytest.raises(ValueError):
            config_from_hparams(str(path))
        return
    assert config_from_hparams(str(path)).to_dict() == JConfig.from_dict(d).to_dict()


# Config fields that steer training or only the JAX programs, not the
# forward a chip_smoke.py phase drives
_NOT_THE_FORWARD = ("bs", "epochs", "wd", "eval_freq", "viz_freq", "data_dir", "steps_per_call",
                    "remat", "stage_scan")


def test_chip_smoke_mimic_config_is_the_flagships():
    """chip_smoke.mimic_config (the registry's mimic192 with MIMIC_FLAGSHIP)
    is the committed mimic192 flagship's hparams.json in every field the
    forward reads."""
    from chip_smoke import mimic_config

    cfg = mimic_config()
    ref = config_from_hparams(str(CKPT / "mimic192_flagship" / "vae" / "hparams.json"))
    assert ref.replace(**{k: getattr(cfg, k) for k in _NOT_THE_FORWARD}) == cfg


def test_pgm_fields_name_each_class_arguments():
    """build_pgm passes each PGM_REGISTRY class exactly the config fields its
    constructor takes (PGM_FIELDS), besides setup_predictors, device and
    generator."""
    from causal_gen_tpu_torch.pgm.flow_pgm import PGM_REGISTRY

    assert sorted(PGM_FIELDS) == sorted(PGM_REGISTRY)
    for prefix, cls in PGM_REGISTRY.items():
        args = set(inspect.signature(cls).parameters)
        assert args == set(PGM_FIELDS[prefix]) | {"setup_predictors", "device", "generator"}


@pytest.mark.parametrize("name,n_vae", [("ukbb192", None), ("mimic192", 7_975_090)])
def test_flagship_converts_with_strict_loads(tmp_path, name, n_vae):
    """The three trees of a flagship: the VAE's stacked decoder runs unstack
    onto the port's blocks, the PGM holds the SCM's nets and the predictor
    the predictors; a save_converted file builds the same DSCM."""
    ck = CKPT / f"{name}_flagship"
    paths = {k: str(ck / k / "checkpoint") for k in ROLES}
    trees = {k: flax_checkpoint_numpy(p, k) for k, p in paths.items()}
    assert any(k.startswith("run_") for k in trees["vae"]["decoder"])
    metas = {k: checkpoint_meta(p) for k, p in paths.items()}
    save_converted(str(tmp_path / "dscm.pt"), trees, metas)
    dscm = load_converted(str(tmp_path / "dscm.pt"), "cpu")
    cfg = config_from_hparams(str(ck / "vae" / "hparams.json"))
    assert dscm.cfg == cfg and cfg.z_max_res == 96 and cfg.stage_scan
    if n_vae is not None:
        assert sum(p.numel() for p in dscm.vae.parameters()) == n_vae
    for mod, sd in zip((dscm.vae, dscm.pgm, dscm.predictor), dscm_state_dicts(
            trees["vae"], trees["pgm"], trees["aux"])):
        got = mod.state_dict()
        assert sorted(got) == sorted(sd)
        for k in sd:
            torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)


def test_final_morpho2_elbo_matches_jax(monkeypatch):
    """checkpoints/final_morpho2 (unrolled layout, float32, Morpho-MNIST): the
    ELBO, NLL and KL of its EMA weights on a batch from a seed, with the same
    posterior draws, within 1e-4 rel."""
    path = str(CKPT / "final_morpho2" / "checkpoint")
    jcfg, state, _ = load_checkpoint(path)
    tree = to_numpy(state.ema_params)
    tcfg = config_from_hparams(path + ".meta.json")
    tvae = HVAE(tcfg, device="cpu")
    tvae.load_state_dict(params_from_jax(unstack_decoder(tree)), strict=True)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4, 32, 32, 1)).astype(np.float32)
    pa = rng.uniform(-1, 1, (4, tcfg.context_dim)).astype(np.float32)
    rec = patch_jax_noise(monkeypatch, seed=13)
    patch_jax_nll_with_port(monkeypatch)
    jvae = JHVAE(cfg=jcfg)
    ref = jax.jit(lambda p, a, b: jvae.apply({"params": p}, a, b, beta=jcfg.beta, train=False,
                                             rngs={"sample": jax.random.PRNGKey(1)}))(
        tree, jnp.asarray(x), jnp.asarray(pa))
    with torch.no_grad():
        out = tvae(nchw(x), torch.from_numpy(pa), beta=tcfg.beta, noise=iter(rec.torch_noise()))
    for k in ("elbo", "nll", "kl"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-4, err_msg=k)


@functools.cache
def _ukbb_obs():
    rng = np.random.default_rng(0)
    x = np.kron(rng.uniform(-1, 1, (1, 24, 24, 1)), np.ones((1, 8, 8, 1)))
    return {"x": x.astype(np.float32), "sex": np.ones((1, 1), np.float32),
            "mri_seq": np.zeros((1, 1), np.float32), "age": np.full((1, 1), 0.1, np.float32),
            "brain_volume": np.full((1, 1), 0.2, np.float32),
            "ventricle_volume": np.full((1, 1), -0.3, np.float32)}


@pytest.mark.parametrize("dtype,past_limit", [("float32", 1), ("bfloat16", 100)])
def test_ukbb192_flagship_forward_matches_jax(monkeypatch, dtype, past_limit):
    """The committed ukbb192 DSCM (EMA weights), do(ventricle_volume = 0.5),
    bs 1: the port's DSCM.forward against the JAX package's. cf_x is the
    documented case of ROADMAP Queue 3 (``past_limit``): in float32 one of
    36,864 pixels is 1.40e-4 from the JAX run, which is itself 1.75e-4 from
    its float64 run there (7 of the JAX run's pixels lie more than 1e-4 from
    that run); in bf16 100 pixels lie past the transfer bound (up to 4.54
    times it), where the JAX run is up to 0.924 from its float64 run (52 of
    the JAX run's pixels lie past the bound from that run)."""
    flagship_forward_check(monkeypatch, str(CKPT / "ukbb192_flagship"), dtype, _ukbb_obs(),
                           {"ventricle_volume": np.full((1, 1), 0.5, np.float32)},
                           past_limit=past_limit)
