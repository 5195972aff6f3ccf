"""Writes ``tests/goldens/cf_ckpt.npz``: the JAX package's ``DSCM.forward``
and next CF update of each committed 32^2 CF tree that
``tests/test_torch_cf_ckpt.py::test_resumed_cf_tree_matches_jax`` holds the
port against (its ``RESUMED``), resumed with ``causal_gen_tpu.pgm.train_cf.
load_cf_checkpoint``, on that test's inputs at bs 1 with ``grad_skip``
lifted. The posterior draws come from a seeded numpy stream
(``torch_parity.patch_jax_noise``), which the test draws again from their
stored shapes; the NLL goes through the
port's function on the JAX side too (``patch_jax_nll_with_port``), as every
parity test routes it. After the update it keeps λ, its EMA, the counters,
the metrics and the elements at ``sample_index`` of every VAE parameter in
the port's layout, of the parameters and of their EMA (concatenated in the
parameters' sorted order).

    JAX_PLATFORMS=cpu python tests/make_cf_ckpt_goldens.py   # ~3 min a tree

The JAX side compiles a full-width CF update for each tree, which is why
the test reads these numbers instead of running it.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from causal_gen_tpu.cli.train_cf import build_pgm_from_ckpt  # noqa: E402
from causal_gen_tpu.config import Config  # noqa: E402
from causal_gen_tpu.models.hvae import HVAE as JHVAE  # noqa: E402
from causal_gen_tpu.pgm import train_cf as jcf  # noqa: E402
from causal_gen_tpu.pgm.dscm import DSCM as JDSCM  # noqa: E402
from causal_gen_tpu_torch.convert import params_from_jax, unstack_decoder  # noqa: E402
from causal_gen_tpu_torch.pgm.train_cf import TERMS  # noqa: E402

from tests.test_torch_cf_ckpt import (  # noqa: E402
    GOLDEN, NOISE_SEED, RESUMED, inputs, paths, sample_index)
from tests.torch_parity import (  # noqa: E402
    patch_jax_nll_with_port, patch_jax_noise, to_numpy, vae_config_path)


def jax_pair(name):
    import json

    cf_path, vae_path, pgm_path, aux_path = paths(name)
    cfg, _ = jcf.load_cf_meta(cf_path)
    cfg = dataclasses.replace(cfg, grad_skip=1e30)
    with open(vae_config_path(vae_path)) as f:
        d = json.load(f)
    vcfg = Config.from_dict(d.get("config", d)).replace(stage_scan=False)
    _, jpgm, pstate = build_pgm_from_ckpt(pgm_path, False)
    _, jpred, astate = build_pgm_from_ckpt(aux_path, True)
    dscm = JDSCM(cfg=vcfg, pgm=jpgm, predictor=jpred, vae=JHVAE(cfg=vcfg),
                 elbo_constraint=cfg.elbo_constraint, lmbda_init=cfg.lmbda_init,
                 damping=cfg.damping, thickness_weight=cfg.thickness_weight,
                 intensity_weight=cfg.intensity_weight,
                 thickness_calib=tuple(cfg.thickness_calib))
    frozen = {"pgm": pstate.ema_params, "predictor": astate.ema_params}
    raw = jcf.load_cf_checkpoint(cf_path)[1]
    vae = unstack_decoder(to_numpy(raw.trainable["vae"]))
    template = jcf.init_cf_state(cfg, dscm, vae)
    _, state, _ = jcf.load_cf_checkpoint(cf_path, template_state=template)
    return cfg, dscm, frozen, state


def main():
    out = {}
    for name in RESUMED:
        cfg, dscm, frozen, state = jax_pair(name)
        obs, do, mask = inputs(name)
        jobs, jdo, jmask = ({k: jnp.asarray(v) for k, v in t.items()} for t in (obs, do, mask))
        with pytest.MonkeyPatch.context() as m:
            rec = patch_jax_noise(m, NOISE_SEED)
            patch_jax_nll_with_port(m)
            fwd = jax.jit(lambda t, f, o, d, k: dscm.forward(t, f, o, d, jax.random.PRNGKey(0),
                                                             do_mask=k))(
                state.trainable, frozen, jobs, jdo, jmask)
            draws = list(rec.draws)
        with pytest.MonkeyPatch.context() as m:
            rec = patch_jax_noise(m, NOISE_SEED)
            patch_jax_nll_with_port(m)
            step = jax.jit(jcf._make_cf_step_body(cfg, dscm, frozen))
            new, met = step(state, jobs, jdo, jmask, jax.random.PRNGKey(1))
            assert all(np.array_equal(a, b) for a, b in zip(rec.draws, draws))
        met = {k: float(v) for k, v in jax.device_get(met).items()}
        assert all(np.isfinite(list(met.values()))) and met["skipped"] == 0.0, met
        print(name, met, flush=True)
        g = {"noise_shapes": np.array([d.shape for d in draws], np.int64),
             "forward/cf_x": np.asarray(fwd["cfs"]["x"]),
             **{f"forward/cfs/{k}": np.asarray(fwd["cfs"][k]) for k in do},
             **{f"forward/{k}": np.asarray(fwd[k]) for k in TERMS},
             **{f"update/{k}": v for k, v in met.items()},
             "update/step": int(new.step), "update/ema_updates": int(new.ema_updates),
             "update/new_lmbda": np.asarray(new.trainable["lmbda"]),
             "update/new_ema_lmbda": np.asarray(new.ema_trainable["lmbda"])}
        for key, tree in (("params", new.trainable["vae"]), ("ema", new.ema_trainable["vae"])):
            sd = params_from_jax(unstack_decoder(to_numpy(tree)))
            g[f"update/{key}"] = np.concatenate([
                sd[k].flatten().numpy()[sample_index(k, sd[k].shape)] for k in sorted(sd)])
        out.update({f"{name}/{k}": v for k, v in g.items()})
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    main()
