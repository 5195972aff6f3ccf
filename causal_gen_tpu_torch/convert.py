"""Flax parameter trees -> PyTorch ``state_dict``s, and whole checkpoints.

``params_from_jax`` takes the nested dict of numpy arrays that a flax module's
``init`` (or an Orbax restore, on a machine with JAX) gives, and returns the
``state_dict`` of the port's counterpart module: the HVAE, the PGM or the
predictor. It reads numpy arrays only, so it imports no JAX; turning an
Orbax checkpoint into such a tree needs JAX and so runs on the JAX side
(``tests/torch_parity.py::flax_checkpoint_numpy``).

A checkpoint saved with ``stage_scan=True`` stacks each run of same-shaped
decoder blocks on a leading axis under ``decoder/run_<start>/block``;
``unstack_decoder`` gives the port's unrolled names back (the inverse of
``causal_gen_tpu/models/hvae.py::migrate_decoder_params``). A DSCM's three
trees (HVAE, PGM, predictor) with their checkpoints' configs go into one
``torch.save`` file (``save_converted``) that ``load_converted`` builds on
the card from, with ``strict=True`` loads; ``save_mechanism_checkpoints``
writes them as the port's own checkpoints instead, which ``cli/train_cf.py``
and ``cli/evaluate.py`` read, and ``cf_state_from_jax`` carries a JAX CF
checkpoint's state (the VAE, λ, their EMA, both optax Adam states) into a
``pgm/train_cf.py::CFTrainState``.

The port's modules carry flax's names, so a key maps by its path:
``decoder/blocks_0/prior/Conv_0/kernel`` -> ``decoder.blocks_0.prior.Conv_0.weight``.
Leaves change as follows:

- conv ``kernel`` (4-D, HWIO) -> ``weight`` in OIHW (the 1x1 convs of the
  heads too: DmolNet's ``likelihood/conv`` keeps the JAX channel order of
  its 10K outputs); a 3-D conv's (5-D, DHWIO) -> OIDHW;
- dense ``kernel`` (2-D, (in, out)) -> ``weight`` in (out, in);
- norm ``scale`` -> ``weight``;
- the decoder's per-resolution ``bias_<r>`` (1, r, r, C) -> (1, C, r, r),
  and a volume's (1, r, r, r, C) -> (1, C, r, r, r);
- every other leaf (biases, ``x_logscale_kernel``, spline and logit
  parameters) is copied as it is.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from causal_gen_tpu_torch.config import Config

_RES_BIAS = re.compile(r"bias_\d+")
_RUN = re.compile(r"run_(\d+)")
ROLES = ("vae", "pgm", "aux")


def _leaf(path: str, name: str, value: np.ndarray) -> tuple:
    a = np.asarray(value, dtype=np.float32)
    if name == "kernel" and a.ndim in (4, 5):  # (*spatial, I, O) -> (O, I, *spatial)
        return "weight", a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))
    if name == "kernel" and a.ndim == 2:
        return "weight", a.T
    if name == "kernel":
        raise ValueError(f"{path}: kernel of rank {a.ndim} has no converter")
    if name == "scale":
        return "weight", a
    if _RES_BIAS.fullmatch(name) and a.ndim in (4, 5):  # (1, *spatial, C) -> (1, C, *spatial)
        return name, a.transpose(0, a.ndim - 1, *range(1, a.ndim - 1))
    return name, a


def params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """``state_dict`` of the port's module for a flax parameter ``tree``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(params_from_jax(value, path + "."))
            continue
        name, a = _leaf(path, key, value)
        out[prefix + name] = torch.tensor(a)
    return out


def _tree_map(fn, tree: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: _tree_map(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def _leaves(tree: Mapping[str, Any]):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v


def unstack_decoder(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """An HVAE tree in the unrolled layout: each ``decoder/run_<start>/block``
    leaf of leading length L becomes ``decoder/blocks_<start + j>`` for j < L;
    the boundary ``blocks_<i>``, the ``bias_<r>`` and everything outside the
    decoder stay as they are. A tree without runs comes back unchanged."""
    dec = tree.get("decoder")
    if not isinstance(dec, Mapping):
        return dict(tree)
    out: Dict[str, Any] = {}
    for key, value in dec.items():
        run = _RUN.fullmatch(key)
        if run is None:
            out[key] = value
            continue
        lengths = {np.shape(a)[0] for a in _leaves(value["block"])}
        if len(lengths) != 1:
            raise ValueError(f"decoder/{key}: leaves of leading lengths {sorted(lengths)}")
        for j in range(lengths.pop()):
            name = f"blocks_{int(run.group(1)) + j}"
            if name in dec:
                raise ValueError(f"decoder/{key} unstacks onto decoder/{name}, which exists")
            out[name] = _tree_map(lambda a, j=j: np.asarray(a)[j], value["block"])
    return {**tree, "decoder": out}


def checkpoint_meta(path: str) -> Dict[str, Any]:
    """The ``<path>.meta.json`` a checkpoint was saved with: its ``config``
    and ``extra``."""
    with open(path + ".meta.json") as f:
        return json.load(f)


def config_from_hparams(path: str) -> Config:
    """The port's ``Config`` from an HVAE checkpoint's ``hparams.json`` (a plain
    config) or ``.meta.json`` (its ``config`` entry). Fields that steer only
    the JAX programs (``stage_scan``, ``remat``, ``use_pallas``, ...) are kept
    and not read by the port; keys that are no field are dropped. Raises on a
    PGM checkpoint's config (it has a ``dataset``)."""
    with open(path) as f:
        d = json.load(f)
    d = d.get("config", d)
    if "dataset" in d:
        raise ValueError(f"{path} holds a PGM's config; build_pgm takes it as a dict")
    return Config.from_dict(d)


def dscm_state_dicts(vae_tree: Mapping[str, Any], pgm_tree: Mapping[str, Any],
                     aux_tree: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The ``state_dict``s of the port's HVAE (decoder unstacked), PGM and
    predictor for a DSCM's three flax trees (their EMA parameters)."""
    return (params_from_jax(unstack_decoder(vae_tree)), params_from_jax(pgm_tree),
            params_from_jax(aux_tree))


# the PGM checkpoint config's fields each PGM_REGISTRY class is built from
# (causal_gen_tpu/cli/train_cf.py::build_pgm_from_ckpt passes the fields its
# flax class has): ChestPGM's nets have fixed widths, so a mimic config's
# ``widths`` is not read, and ColourMNISTPGM has no SCM net and predictors on
# RGB whatever ``input_channels`` says (the JAX CNN takes its input's channels)
PGM_FIELDS = {
    "ukbb": ("widths", "std_fixed", "input_res", "input_channels"),
    "morphomnist": ("widths", "std_fixed", "input_res", "input_channels"),
    "cmnist": ("std_fixed", "input_res"),
    "mimic": ("std_fixed", "input_res", "input_channels"),
}


def build_pgm(pgm_cfg: Mapping[str, Any], setup_predictors: bool,
              device: "str | torch.device" = "cuda",
              generator: "torch.Generator | None" = None) -> torch.nn.Module:
    """The port's PGM for a PGM config (a checkpoint's, or
    ``pgm/train_pgm.py::PGMConfig`` as a dict: its ``dataset``, its
    ``setup`` and the fields ``PGM_FIELDS`` names), as the PGM
    (``setup_predictors=False``) or the predictor
    (causal_gen_tpu/cli/train_cf.py::build_pgm_from_ckpt). A ``semi_sup``
    config's module holds both the SCM's nets and the predictors, as its
    checkpoint does, in either role."""
    from causal_gen_tpu_torch.pgm.flow_pgm import PGM_REGISTRY

    semi = pgm_cfg.get("setup") == "semi_sup"
    for prefix, cls in PGM_REGISTRY.items():
        if pgm_cfg["dataset"].startswith(prefix):
            kw = {k: tuple(pgm_cfg[k]) if k == "widths" else pgm_cfg[k]
                  for k in PGM_FIELDS[prefix]}
            if semi and prefix in ("ukbb", "mimic", "morphomnist"):
                kw["scm_nets"] = True
            return cls(**kw, setup_predictors=setup_predictors or semi, device=device,
                       generator=generator)
    raise KeyError(f"no PGM for dataset {pgm_cfg['dataset']!r}")


def build_dscm(vae_cfg: Config, pgm_cfg: Mapping[str, Any], aux_cfg: Mapping[str, Any],
               state_dicts: Tuple[Dict[str, torch.Tensor], ...],
               device: "str | torch.device" = "cuda", elbo_constraint: float = 0.0):
    """A ``DSCM`` on ``device`` whose image mechanism (``vae_cfg.vae``: the
    HVAE or the simple VAE), PGM and predictor load
    ``state_dicts`` (``dscm_state_dicts``) with ``strict=True``."""
    from causal_gen_tpu_torch.models.simple_vae import build_vae
    from causal_gen_tpu_torch.pgm.dscm import DSCM

    mods = (build_vae(vae_cfg, device=device), build_pgm(pgm_cfg, False, device),
            build_pgm(aux_cfg, True, device))
    for mod, sd in zip(mods, state_dicts):
        mod.load_state_dict(sd, strict=True)
    return DSCM(vae_cfg, mods[1], mods[2], mods[0], elbo_constraint=elbo_constraint)


def save_converted(path: str, trees: Mapping[str, Mapping[str, Any]],
                   metas: Mapping[str, Mapping[str, Any]]) -> None:
    """One ``torch.save`` file for a DSCM: ``trees`` and ``metas`` map "vae",
    "pgm" and "aux" to each checkpoint's EMA parameter tree (numpy) and its
    ``checkpoint_meta``. ``load_converted`` reads it."""
    state = dscm_state_dicts(*(trees[r] for r in ROLES))
    torch.save({"state_dicts": dict(zip(ROLES, state)),
                "configs": {r: dict(metas[r]["config"]) for r in ROLES},
                "vae_extra": dict(metas["vae"].get("extra", {}))}, path)


def load_converted(path: str, device: "str | torch.device" = "cuda"):
    """The ``DSCM`` of a ``save_converted`` file on ``device``; the
    Lagrangian's ELBO constraint is the HVAE checkpoint's best ELBO, as
    causal_gen_tpu/cli/train_cf.py takes it."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    cfgs = payload["configs"]
    return build_dscm(Config.from_dict(cfgs["vae"]), cfgs["pgm"], cfgs["aux"],
                      tuple(payload["state_dicts"][r] for r in ROLES), device,
                      elbo_constraint=float(payload["vae_extra"].get("best_loss", 0.0)))


def _load_adam(opt: torch.optim.Optimizer, names, mu: Mapping[str, torch.Tensor],
               nu: Mapping[str, torch.Tensor], count) -> None:
    """``opt`` (one group, its parameters named ``names`` in order) takes
    optax's Adam state: ``mu``, ``nu`` and ``count`` become ``exp_avg``,
    ``exp_avg_sq`` and ``step``."""
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
                       "exp_avg": mu[n].clone(), "exp_avg_sq": nu[n].clone()}
                   for i, n in enumerate(names)}
    opt.load_state_dict(sd)


def cf_state_from_jax(tree: Mapping[str, Any], state):
    """In place: a ``pgm/train_cf.py::CFTrainState`` takes a JAX CF
    checkpoint's state, given as the numpy tree of its Orbax restore
    (``tests/torch_parity.py::flax_checkpoint_numpy(path, "cf")``):
    ``trainable`` and ``ema_trainable`` (the VAE, decoder unstacked, with
    ``strict=True`` loads, and λ), the VAE's AdamW state
    (``opt_state[0]``) and λ's (``lagrange_opt_state[1][0]``, behind the
    ``scale(-1)``; its moments are those of -grad, as ``maximize=True``
    keeps them), and the counters. A run resumed from it takes the JAX
    run's next update.

    An eval-grade export (``tools/export_eval_ckpt.py --kind cf``: the
    flagships' CF trees) keeps ``ema_trainable`` alone, the other trees
    empty: the EMA loads into both the model and its EMA, the optimizers
    stay fresh, the counters are the tree's. Returns ``state``."""
    def vae_sd(t):
        return params_from_jax(unstack_decoder(t))

    eval_grade = not tree["trainable"]
    trees = ((state.dscm, tree["ema_trainable" if eval_grade else "trainable"]),
             (state.ema, tree["ema_trainable"]))
    for d, t in trees:
        d.vae.load_state_dict(vae_sd(t["vae"]), strict=True)
        with torch.no_grad():
            d.lmbda.copy_(torch.tensor(np.asarray(t["lmbda"], np.float32).reshape(1)))
    if not eval_grade:
        adam = tree["opt_state"][0]
        _load_adam(state.optimizer, [n for n, _ in state.dscm.vae.named_parameters()],
                   vae_sd(adam["mu"]), vae_sd(adam["nu"]), adam["count"])
        l_adam = tree["lagrange_opt_state"][1][0]
        _load_adam(state.lagrange_optimizer, ["lmbda"],
                   {"lmbda": torch.tensor(np.asarray(l_adam["mu"], np.float32))},
                   {"lmbda": torch.tensor(np.asarray(l_adam["nu"], np.float32))},
                   l_adam["count"])
    state.step, state.ema_updates, state.skipped = (int(tree[k]) for k in
                                                    ("step", "ema_updates", "skipped"))
    return state


def save_mechanism_checkpoints(directory: str, trees: Mapping[str, Mapping[str, Any]],
                               metas: Mapping[str, Mapping[str, Any]]) -> Dict[str, str]:
    """A DSCM's three JAX checkpoints as the port's own, for
    ``cli/train_cf.py`` and ``cli/evaluate.py``: ``<directory>/{vae,pgm,aux}/
    checkpoint`` (``trees`` and ``metas`` as ``save_converted`` takes them).
    The EMA tree goes in as both the parameters and their EMA, beside fresh
    optimizer states. Returns the three paths."""
    import os

    from causal_gen_tpu_torch.models.simple_vae import build_vae
    from causal_gen_tpu_torch.pgm.train_pgm import PGMConfig, init_pgm_state, save_pgm_checkpoint
    from causal_gen_tpu_torch.train.checkpoint import state_payload, write_payload
    from causal_gen_tpu_torch.train.state import init_train_state

    sds = dict(zip(ROLES, dscm_state_dicts(*(trees[r] for r in ROLES))))
    paths = {r: os.path.join(os.path.abspath(directory), r, "checkpoint") for r in ROLES}
    for p in paths.values():
        os.makedirs(os.path.dirname(p), exist_ok=True)
    cfg = Config.from_dict(dict(metas["vae"]["config"]))
    vae = build_vae(cfg, device="cpu")
    vae.load_state_dict(sds["vae"], strict=True)
    write_payload(paths["vae"], state_payload(init_train_state(cfg, vae)),
                  {"config": cfg.to_dict(), "extra": dict(metas["vae"].get("extra", {}))})
    for role in ("pgm", "aux"):
        pcfg = PGMConfig.from_dict(dict(metas[role]["config"]))
        mod = build_pgm(pcfg.to_dict(), pcfg.setup != "sup_pgm", "cpu")
        mod.load_state_dict(sds[role], strict=True)
        save_pgm_checkpoint(paths[role], pcfg, init_pgm_state(pcfg, mod),
                            extra=dict(metas[role].get("extra", {})))
    return paths
