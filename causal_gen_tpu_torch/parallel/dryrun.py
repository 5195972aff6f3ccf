"""Entry points of the port: a forward to run, and a dry run of the parallel
training steps on n ranks.

Counterpart of ``__graft_entry__.py`` (``entry`` :9, ``dryrun_multichip``
:34, its phases :75-251). ``dryrun_multidevice(n)`` starts n ranks
(``parallel/launch.py``: on the card by default, on the CPU over gloo when
the caller asks) and runs JAX's three phases on their mesh, each one step:

1. the tiny Morpho-MNIST HVAE's train step on (data, model) with 2-way
   tensor parallelism from 16 out channels at n >= 4 even, and 2-way
   spatial sharding as well at n >= 8 divisible by 4;
2. the DSCM's counterfactual update on the same mesh (data parallel,
   replicated along the other axes);
3. a train step of the ``ukbb192`` geometry (192^2, the registry's widths
   and dtype, ``stage_scan`` with remat from 48^2, one block a stage,
   tensor-parallel from 256 out channels, spatially sharded with 2-way
   ``space``), one image a ``data`` rank.

Each phase checks that its metrics are finite and that every rank took the
same update.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from causal_gen_tpu_torch import resolve_device


def entry(device: "str | torch.device" = "cuda") -> Tuple[Callable, Tuple]:
    """(fn, args): the flagship Morpho-MNIST HVAE's forward at bs 8 on
    ``device`` (the card unless the caller asks for the CPU); ``fn(*args)``
    returns the ELBO terms."""
    from causal_gen_tpu_torch.config import get_config
    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.train.vae_trainer import preprocess_x

    device = resolve_device(device)
    cfg = get_config("morphomnist", bs=8)
    model = HVAE(cfg, device=device, generator=torch.Generator().manual_seed(0))

    @torch.inference_mode()
    def fwd(x, pa, generator):
        return model(preprocess_x(x), pa, beta=cfg.beta, generator=generator, train=False)

    x = torch.zeros((cfg.bs, cfg.input_channels, cfg.input_res, cfg.input_res), dtype=torch.uint8,
                    device=device)
    pa = torch.zeros((cfg.bs, cfg.context_dim), device=device)
    return fwd, (x, pa, torch.Generator().manual_seed(1))


def mesh_plan(n: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """JAX's dry-run mesh for n ranks: 2-way ``model`` at n >= 4 even, 2-way
    ``space`` at n >= 8 divisible by 4, the rest ``data``."""
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    n_space = 2 if n % 4 == 0 and n >= 8 else 1
    n_data = n // (n_model * n_space)
    if n_space > 1:
        return (n_data, n_model, n_space), ("data", "model", "space")
    return (n_data, n_model), ("data", "model")


def _same_everywhere(mesh, value: float, what: str, device) -> None:
    """Raises unless every rank holds the same ``value``."""
    from causal_gen_tpu_torch.parallel.collectives import gather_parts

    vals = [float(v) for v in gather_parts(torch.tensor([value], dtype=torch.float64,
                                                        device=device),
                                           mesh.group(*mesh.axis_names))]
    if not all(np.isfinite(vals)) or max(vals) != min(vals):
        raise AssertionError(f"{what}: ranks hold {vals}")


def _hvae_step(mesh, device, cfg, tp_min: int, seed: int) -> Dict[str, float]:
    """One train step of ``cfg``'s HVAE on this rank's part of a zero batch."""
    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.parallel.mesh import shard_batch_spatial, shard_params_tp
    from causal_gen_tpu_torch.train.state import global_norm, init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import train_step

    model = HVAE(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    shard_params_tp(model, mesh, tp_min)
    state = init_train_state(cfg, model)
    res, nd = cfg.input_res, cfg.spatial_dims
    batch = {"x": torch.zeros((cfg.bs, cfg.input_channels) + (res,) * nd, dtype=torch.uint8,
                              device=device),
             "pa": torch.zeros((cfg.bs, cfg.context_dim), device=device)}
    batch = shard_batch_spatial(mesh, batch, microbatches=cfg.accu_steps)
    m = train_step(cfg, state, batch, generator=mesh.generator(seed), mesh=mesh)
    out = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(v) for v in out.values()) or state.step != 1:
        raise AssertionError(f"HVAE step: {out}, step {state.step}")
    # replicated parameters agree on every rank; shards on their replicas
    from causal_gen_tpu_torch.parallel.tensor import sharded_parameters

    sharded = sharded_parameters(model)
    norm = global_norm([p.detach() for p in model.parameters() if id(p) not in sharded])
    _same_everywhere(mesh, float(norm), "replicated parameters' norm after the update", device)
    _same_everywhere(mesh, out["elbo"], "elbo", device)
    return out


def _cf_step(mesh, device, seed: int) -> Dict[str, float]:
    """One counterfactual update of a seeded small Morpho-MNIST DSCM on this
    rank's rows of a synthetic batch."""
    from causal_gen_tpu_torch.pgm.dscm import DSCM
    from causal_gen_tpu_torch.pgm.flow_pgm import MorphoMNISTPGM
    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.parallel.mesh import replicate, shard_batch
    from causal_gen_tpu_torch.pgm import train_cf as tcf

    cfg = _tiny_cfg(2 * mesh.size("data"))
    g = torch.Generator().manual_seed(seed)
    vae = HVAE(cfg, device=device, generator=g)
    pgm = MorphoMNISTPGM(setup_predictors=False, device=device, generator=g)
    pred = MorphoMNISTPGM(setup_predictors=True, input_res=cfg.input_res, device=device,
                          generator=g)
    for module in (vae, pgm, pred):
        replicate(module, mesh)
    dscm = DSCM(cfg, pgm, pred, vae, elbo_constraint=1.8)
    ccfg = tcf.CFConfig(bs=cfg.bs, grad_skip=1e9, elbo_constraint=1.8)
    state = tcf.init_cf_state(ccfg, dscm)
    host = np.random.default_rng(0)
    bs, res = cfg.bs, cfg.input_res
    batch = {"x": torch.from_numpy(host.uniform(-1, 1, (bs, 1, res, res)).astype(np.float32)),
             "thickness": torch.from_numpy(host.uniform(-0.8, 0.8, (bs, 1)).astype(np.float32)),
             "intensity": torch.from_numpy(host.uniform(-0.8, 0.8, (bs, 1)).astype(np.float32)),
             "digit": torch.from_numpy(np.eye(10, dtype=np.float32)[host.integers(0, 10, bs)])}
    batch = {k: v.to(device) for k, v in batch.items()}
    dag = tuple(dscm.pgm.dag_variables)
    dov, dom = tcf.dense_intervention(dag, batch, {"thickness": torch.full((bs, 1), 0.2,
                                                                          device=device)})
    batch, dov, dom = (shard_batch(mesh, t) for t in (batch, dov, dom))
    m = tcf.cf_train_step(ccfg, state, batch, dov, dom, generator=mesh.generator(seed), mesh=mesh)
    out = {k: float(v) for k, v in m.items()}
    if not math.isfinite(out["loss"]) or state.step != 1:
        raise AssertionError(f"CF update: {out}, step {state.step}")
    _same_everywhere(mesh, float(state.dscm.lmbda.detach()[0]), "lambda", device)
    return out


def _tiny_cfg(bs: int):
    from causal_gen_tpu_torch.config import get_config

    return get_config("morphomnist", bs=bs, input_res=16, enc_arch="16b1d2,8b1d2,4b1d4,1b1",
                      dec_arch="1b1,4b1,8b1,16b1", widths=(8, 8, 16, 16), z_dim=4,
                      context_dim=12, accu_steps=1, bias_max_res=16)


def ukbb192_geometry(bs: int):
    """JAX's phase-3 config: the registry's ukbb192 at one block a stage,
    with the flagship's z_max_res, beta, wd and posterior init and its
    training layout (stage_scan, remat from 48^2)."""
    from causal_gen_tpu_torch.config import get_config

    return get_config("ukbb192", bs=bs, enc_arch="192b1d2,96b1d2,48b1d2,24b1d2,12b1d2,6b1d6,1b1",
                      dec_arch="1b1,6b1,12b1,24b1,48b1,96b1,192b1", z_max_res=96, beta=5.0,
                      wd=0.05, stage_scan=True, remat=True, remat_min_res=48,
                      posterior_init_scale=0.0, accu_steps=1)


def _dryrun_rank(rank: int, world: int, device) -> Dict[str, Any]:
    from causal_gen_tpu_torch.parallel.mesh import make_mesh

    shape, axes = mesh_plan(world)
    mesh = make_mesh(shape, axes)
    n_data = mesh.size("data")
    return {"mesh": dict(zip(axes, shape)),
            "hvae": _hvae_step(mesh, device, _tiny_cfg(2 * n_data), tp_min=16, seed=0),
            "cf": _cf_step(mesh, device, seed=2),
            "ukbb192": _hvae_step(mesh, device, ukbb192_geometry(max(n_data, 1)), tp_min=256,
                                  seed=4)}


def dryrun_multidevice(n_devices: int, device: "str | torch.device" = "cuda",
                       backend: Optional[str] = None, timeout: float = 600.0
                       ) -> Dict[str, Any]:
    """The three phases on ``n_devices`` ranks (module docstring); returns
    rank 0's metrics. Raises if a rank fails, disagrees or hangs.

    The ranks run on the card unless the caller passes ``device="cpu"``
    (gloo); with no card it raises. On CUDA the backend is NCCL, one card a
    rank, or gloo where the ranks share cards (more ranks than cards, or
    one card named by its index; NCCL refuses two ranks on one card).
    ``backend`` overrides the choice."""
    from causal_gen_tpu_torch.parallel.launch import spawn

    device = resolve_device(device)
    if backend is None and device.type == "cuda":
        shared = device.index is not None or n_devices > torch.cuda.device_count()
        backend = "gloo" if shared else "nccl"
    return spawn(_dryrun_rank, n_devices, device=str(device), backend=backend,
                 timeout=timeout)[0]
