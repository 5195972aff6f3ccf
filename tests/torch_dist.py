"""Rank bodies and shared inputs of the port's parallel tests
(``tests/test_torch_parallel*.py``).

``causal_gen_tpu_torch.parallel.launch.spawn`` starts each rank in a fresh
process that imports this module, so it imports neither JAX nor the JAX
package: a rank is a plain PyTorch process on the CPU over gloo. Inputs are
made by numpy from a seed, outside the ranks, and a rank returns numpy
arrays. ``run_hvae_steps`` is the one code path that both a rank (with its
``Mesh``) and the one-process reference (``mesh=None``) run.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from causal_gen_tpu_torch.config import Config, get_config
from causal_gen_tpu_torch.models.hvae import HVAE, plan_decoder_blocks
from causal_gen_tpu_torch.parallel import (
    batch_sharding,
    make_mesh,
    shard_batch,
    shard_batch_spatial,
    shard_params_tp,
)
from causal_gen_tpu_torch.parallel.tensor import gather_state
from causal_gen_tpu_torch.train.state import init_train_state
from causal_gen_tpu_torch.train.vae_trainer import train_step

TIMEOUT_S = 300  # a hung rank fails its test after this long (ranks take 5-40 s)


def tiny_cfg(**kw) -> Config:
    """The tiny Morpho-MNIST HVAE of tests/test_train.py::tiny_cfg."""
    base = dict(bs=8, input_res=16, enc_arch="16b1d2,8b1d2,4b1d4,1b1",
                dec_arch="1b1,4b1,8b1,16b1", widths=(8, 8, 16, 16), z_dim=4,
                context_dim=12, accu_steps=1, bias_max_res=16, lr=1e-3,
                lr_warmup_steps=10)
    base.update(kw)
    return get_config("morphomnist", **base)


def hvae_inputs(cfg: Config, n_steps: int, seed: int = 0) -> List[Dict[str, Any]]:
    """Per step: a uint8 NC(D)HW batch of ``cfg.bs`` rows, its parents, and
    the standard normals of every stochastic block a microbatch, each a
    whole map."""
    rng = np.random.default_rng(seed)
    nd, res, accu = cfg.spatial_dims, cfg.input_res, cfg.accu_steps
    micro = cfg.bs // accu
    blocks = [r for r, _ in plan_decoder_blocks(cfg) if r <= cfg.z_max_res]
    steps = []
    for _ in range(n_steps):
        steps.append({
            "x": rng.integers(0, 256, (cfg.bs, cfg.input_channels) + (res,) * nd
                              ).astype(np.uint8),
            "pa": rng.uniform(-1, 1, (cfg.bs, cfg.context_dim)).astype(np.float32),
            "noise": [[rng.standard_normal((micro, cfg.z_dim) + (r,) * nd).astype(np.float32)
                       for r in blocks] for _ in range(accu)]})
    return steps


def build_hvae(cfg: Config, seed: int = 0) -> HVAE:
    return HVAE(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def rank_rows(mesh, a: np.ndarray) -> np.ndarray:
    """This rank's rows of one microbatch's array (its ``data`` share)."""
    return a[batch_sharding(mesh, len(a))]


def run_hvae_steps(cfg: Config, steps: List[Dict[str, Any]], mesh=None, tp_min: int = 0,
                   spatial: bool = False, seed: int = 0) -> Dict[str, Any]:
    """``len(steps)`` train steps of a seeded HVAE (``run_steps_on``)."""
    return run_steps_on(cfg, build_hvae(cfg, seed), steps, mesh, tp_min, spatial)


def run_steps_on(cfg: Config, model: HVAE, steps: List[Dict[str, Any]], mesh=None,
                 tp_min: int = 0, spatial: bool = False) -> Dict[str, Any]:
    """``len(steps)`` train steps of ``model``; under ``mesh`` on this rank's
    part (tensor-parallel from ``tp_min`` when > 0, spatially sharded with
    ``spatial``). Returns each step's metrics and the whole parameters and
    EMA after the last."""
    if mesh is not None:
        shard_params_tp(model, mesh, tp_min or 10**9)
    state = init_train_state(cfg, model)
    metrics = []
    for st in steps:
        batch = {"x": torch.from_numpy(st["x"]), "pa": torch.from_numpy(st["pa"])}
        noise = [[torch.from_numpy(e) for e in mb] for mb in st["noise"]]
        if mesh is not None:
            shard = shard_batch_spatial if spatial else shard_batch
            batch = shard(mesh, batch, microbatches=cfg.accu_steps)
            noise = [[torch.from_numpy(rank_rows(mesh, e.numpy())) for e in mb] for mb in noise]
        m = train_step(cfg, state, batch, noise=noise, mesh=mesh)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": {k: v.numpy() for k, v in gather_state(state.model).items()},
            "ema": {k: v.numpy() for k, v in gather_state(state.ema).items()},
            "lr": state.scheduler.get_last_lr()[0]}


def hvae_rank(rank: int, world: int, device, cfg: Config, steps, shape, axes,
              tp_min: int = 0, spatial: bool = False):
    return run_hvae_steps(cfg, steps, make_mesh(tuple(shape), tuple(axes)), tp_min, spatial)


# ---- PGM steps (pgm/train_pgm.py) -------------------------------------------

PGM_N = 8  # global batch of the PGM and CF checks


def morpho_obs(n: int, res: int, seed: int) -> Dict[str, np.ndarray]:
    """A loader batch (concat_pa=False): uint8 NHWC x with a bright block
    and the three Morpho-MNIST parents in the PGM's space."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, res, res, 1), np.float32)
    x[:, res // 4:3 * res // 4, res // 4:res // 2 + 2] = rng.uniform(0.5, 1.0, (n, res // 2, 2 + res // 4, 1))
    x += rng.uniform(0, 0.2, x.shape)
    return {"x": (np.clip(x, 0, 1) * 255).astype(np.uint8),
            "thickness": rng.uniform(-0.8, 0.8, (n, 1)).astype(np.float32),
            "intensity": rng.uniform(-0.8, 0.8, (n, 1)).astype(np.float32),
            "digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]}


def guide_draws(n: int, seed: int) -> Dict[str, np.ndarray]:
    """The Morpho-MNIST guide's draws by site: normals for intensity and
    thickness, standard Gumbels for the digit."""
    rng = np.random.default_rng(seed)
    return {"intensity": rng.standard_normal((n, 1)).astype(np.float32),
            "thickness": rng.standard_normal((n, 1)).astype(np.float32),
            "digit": rng.gumbel(size=(n, 10)).astype(np.float32)}


def run_pgm_steps(setup: str, n_steps: int = 2, mesh=None) -> Dict[str, Any]:
    """``n_steps`` sup_pgm or semi_sup updates of a seeded Morpho-MNIST PGM
    at a global batch of PGM_N; under ``mesh`` on this rank's rows."""
    from causal_gen_tpu_torch.pgm.flow_pgm import MorphoMNISTPGM
    from causal_gen_tpu_torch.pgm import train_pgm as tp

    cfg = tp.PGMConfig(dataset="morphomnist", setup=setup, bs=PGM_N, lr=1e-3, input_res=16)
    semi = setup == "semi_sup"
    pgm = MorphoMNISTPGM(setup_predictors=semi, scm_nets=True if semi else None,
                         input_res=cfg.input_res, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    if mesh is not None:
        shard_params_tp(pgm, mesh, 10**9)
    state = tp.init_pgm_state(cfg, pgm)

    def rows(b):
        return b if mesh is None else shard_batch(mesh, b)

    metrics = []
    for s in range(n_steps):
        if semi:
            draws = {k: torch.from_numpy(v) for k, v in guide_draws(PGM_N, 50 + s).items()}
            m = tp.semi_sup_step(
                cfg, state, rows(tp.preprocess_pgm_batch(cfg, morpho_obs(PGM_N, 16, 20 + s), "cpu")),
                rows(tp.preprocess_pgm_batch(cfg, morpho_obs(PGM_N, 16, 30 + s), "cpu")), 50,
                draws=rows(draws), mesh=mesh)
        else:
            m = tp.train_step(cfg, state, rows(tp.preprocess_pgm_batch(
                cfg, morpho_obs(PGM_N, 16, 10 + s), "cpu")), mesh=mesh)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": {k: v.detach().numpy() for k, v in state.model.state_dict().items()},
            "ema": {k: v.detach().numpy() for k, v in state.ema.state_dict().items()}}


# ---- the CF update (pgm/train_cf.py) ----------------------------------------

CF_EPS = 1.8  # the ELBO constraint: well below the ELBO, so the damping term is large


def build_dscm(seed: int = 0):
    """A small Morpho-MNIST DSCM (16^2, tiny_cfg's HVAE with std_init 1 as
    tests/test_parallel_pgm.py pins it) with seeded parameters."""
    from causal_gen_tpu_torch.pgm.dscm import DSCM
    from causal_gen_tpu_torch.pgm.flow_pgm import MorphoMNISTPGM

    cfg = tiny_cfg(std_init=1.0, context_dim=12)
    g = torch.Generator().manual_seed(seed)
    vae = HVAE(cfg, device="cpu", generator=g)
    pgm = MorphoMNISTPGM(setup_predictors=False, device="cpu", generator=g)
    pred = MorphoMNISTPGM(setup_predictors=True, input_res=cfg.input_res, device="cpu",
                          generator=g)
    return cfg, DSCM(cfg, pgm, pred, vae, elbo_constraint=CF_EPS)


def run_cf_updates(n_steps: int = 2, accu: int = 1, mesh=None) -> Dict[str, Any]:
    """``n_steps`` CF updates under do(thickness) permuted, with injected
    draws; under ``mesh`` on this rank's rows."""
    from causal_gen_tpu_torch.pgm import train_cf as tcf
    from causal_gen_tpu_torch.pgm.train_pgm import PGMConfig, preprocess_pgm_batch

    cfg, dscm = build_dscm()
    ccfg = tcf.CFConfig(bs=PGM_N, grad_skip=1e9, elbo_constraint=CF_EPS, accu_steps=accu,
                        do_pa="thickness")
    state = tcf.init_cf_state(ccfg, dscm)
    dag = tuple(dscm.pgm.dag_variables)
    blocks = [r for r, _ in plan_decoder_blocks(cfg) if r <= cfg.z_max_res]
    micro = PGM_N // accu
    metrics = []
    for s in range(n_steps):
        batch = preprocess_pgm_batch(PGMConfig(input_res=16), morpho_obs(PGM_N, 16, 40 + s), "cpu")
        do = tcf.random_intervention(np.random.default_rng(s), dag, batch, "thickness")
        dov, dom = tcf.dense_intervention(dag, batch, do)
        rng = np.random.default_rng(60 + s)
        noise = [[torch.from_numpy(rng.standard_normal((micro, cfg.z_dim, r, r)).astype(np.float32))
                  for r in blocks * 2] for _ in range(accu)]
        if mesh is not None:
            batch, dov, dom = (shard_batch(mesh, t, microbatches=accu) for t in (batch, dov, dom))
            noise = [[torch.from_numpy(rank_rows(mesh, e.numpy())) for e in mb] for mb in noise]
        m = tcf.cf_train_step(ccfg, state, batch, dov, dom, noise=noise, mesh=mesh)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "vae": {k: v.detach().numpy() for k, v in state.dscm.vae.state_dict().items()},
            "lmbda": float(state.dscm.lmbda.detach()[0]), "lr": ccfg.lr}


# ---- tensor parallelism ------------------------------------------------------

TP_MIN = 8  # tiny_cfg's convs from 8 out channels up are split over `model`


def full_grads(model) -> Dict[str, np.ndarray]:
    """Every parameter's gradient, a sharded weight's gathered whole."""
    from causal_gen_tpu_torch.parallel.collectives import gather_parts
    from causal_gen_tpu_torch.parallel.tensor import sharded_layers

    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    for name, layer in sharded_layers(model).items():
        grads[f"{name}.weight"] = torch.cat(
            gather_parts(layer.weight.grad.detach(), layer.tp_mesh.group("model")), 0)
    return {k: v.numpy() for k, v in grads.items()}


def hvae_loss_grads(cfg: Config, step: Dict[str, Any], mesh=None, tp_min: int = TP_MIN,
                    spatial: bool = False) -> Dict[str, Any]:
    """The ELBO of a seeded HVAE on ``step``'s batch and its gradients; under
    ``mesh`` tensor-parallel from ``tp_min``, on this rank's rows (and its
    slab with ``spatial``), the ELBO and the gradients reduced as the train
    step reduces them."""
    from causal_gen_tpu_torch.train.vae_trainer import preprocess_x

    model = build_hvae(cfg)
    batch = {"x": torch.from_numpy(step["x"]), "pa": torch.from_numpy(step["pa"])}
    noise = [torch.from_numpy(e) for e in step["noise"][0]]
    if mesh is not None:
        shard_params_tp(model, mesh, tp_min)
        batch = (shard_batch_spatial if spatial else shard_batch)(mesh, batch)
        noise = [torch.from_numpy(rank_rows(mesh, e.numpy())) for e in noise]
    out = model(preprocess_x(batch["x"]), batch["pa"], noise=iter(noise), mesh=mesh)
    out["elbo"].backward()
    elbo = out["elbo"].detach()
    if mesh is not None:  # each rank's copy of the loss -> the one loss's gradient
        from causal_gen_tpu_torch.parallel.tensor import sharded_parameters

        mesh.reduce_gradients(model.parameters(), sharded_parameters(model))
        elbo = mesh.reduce_metrics({"elbo": elbo})["elbo"]
    return {"elbo": float(elbo), "grads": full_grads(model)}


def assert_grads_match(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray],
                       rtol: float = 1e-5) -> None:
    """Every parameter's gradient within ``rtol`` of its largest element."""
    assert sorted(ref) == sorted(got)
    for k, g in ref.items():
        np.testing.assert_allclose(got[k], g, rtol=0,
                                   atol=rtol * max(float(np.abs(g).max()), 1e-12), err_msg=k)


def assert_params_close(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray], lr: float,
                        n_updates: int, what: Any = "") -> None:
    """Parameters after ``n_updates`` AdamW updates from one state: every
    element within 2 lr an update, and all but one in a thousand within
    1e-5. The first bound alone cannot fail (Adam's first update is
    lr g / (|g| + eps), so two first updates differ by 2 lr at most); the
    share catches a wrong gradient, which moves most elements, while an
    element whose gradient is at rounding level may move either way."""
    errs = np.concatenate([np.abs(ref[k] - got[k]).ravel() for k in ref])
    assert errs.max() <= 2 * lr * n_updates, (what, float(errs.max()))
    assert (errs > 1e-5).mean() <= 1e-3, (what, int((errs > 1e-5).sum()), errs.size)


def uneven_module(mesh=None):
    """Three layers of out channels 6, 5 and 8, from a seed; split over a
    2-rank ``model`` axis from 5 up, the 5 does not split evenly."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Conv2d(4, 6, 3, padding=1), torch.nn.Conv2d(6, 5, 1),
                            torch.nn.Flatten(), torch.nn.Linear(5 * 4 * 4, 8))
    if mesh is not None:
        shard_params_tp(m, mesh, 5)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4, 4, 4)).astype(np.float32))
    return m, m(x).detach().numpy()


def tp_checkpoint_run(cfg: Config, steps, path: str, mesh=None) -> Dict[str, Any]:
    """One step, a checkpoint to ``path`` (whole tensors), the next step;
    then a fresh model restored from ``path`` takes that next step again."""
    from causal_gen_tpu_torch.train.checkpoint import (
        restore_train_state,
        state_payload,
        write_payload,
    )

    def step_on(state, st):
        batch = {"x": torch.from_numpy(st["x"]), "pa": torch.from_numpy(st["pa"])}
        noise = [[torch.from_numpy(e) for e in mb] for mb in st["noise"]]
        return {k: float(v) for k, v in train_step(cfg, state, batch, noise=noise,
                                                    mesh=mesh).items()}

    def fresh():
        model = build_hvae(cfg, seed=1)
        return model if mesh is None else shard_params_tp(model, mesh, TP_MIN)

    state = init_train_state(cfg, fresh())
    step_on(state, steps[0])
    payload = state_payload(state)
    if mesh is None or mesh.rank == 0:
        write_payload(path, payload, {"config": cfg.to_dict()})
    if mesh is not None:
        torch.distributed.barrier()
    out = {"next": step_on(state, steps[1]),
           "params": {k: v.numpy() for k, v in gather_state(state.model).items()}}
    restored = restore_train_state(cfg, fresh(), torch.load(path, weights_only=True))
    out["restored_next"] = step_on(restored, steps[1])
    out["restored_params"] = {k: v.numpy() for k, v in gather_state(restored.model).items()}
    return out


def tp_rank(rank: int, world: int, device, cfg: Config, steps, path: str) -> Dict[str, Any]:
    from causal_gen_tpu_torch.parallel.tensor import sharded_layers

    mesh = make_mesh((1, world), ("data", "model"))
    n_sharded = len(sharded_layers(shard_params_tp(build_hvae(cfg), mesh, TP_MIN)))
    m, y = uneven_module(mesh)
    return {"steps": run_hvae_steps(cfg, steps, mesh, tp_min=TP_MIN),
            "loss_grads": hvae_loss_grads(cfg, steps[0], mesh), "n_sharded": n_sharded,
            "uneven": {"classes": [type(l).__name__ for l in m], "out": y,
                       "weights": [tuple(l.weight.shape) for l in m if hasattr(l, "weight")]},
            "checkpoint": tp_checkpoint_run(cfg, steps, path, mesh)}


# ---- spatial parallelism -----------------------------------------------------

def gather_latents(mesh, sp, zs, cfg: Config) -> List[np.ndarray]:
    """Whole latents (every row, every slab) from this rank's."""
    from causal_gen_tpu_torch.parallel.collectives import all_gather

    res = [r for r, _ in plan_decoder_blocks(cfg) if r <= cfg.z_max_res]
    out = []
    for z, r in zip(zs, res):
        if sp.sharded(r):
            z = sp.gather(z)
        out.append(all_gather(z.detach().contiguous(), 0, mesh.group("data")).numpy())
    return out


def sp_abduct(cfg: Config, step, mesh=None) -> List[np.ndarray]:
    """The abduction latents of a seeded HVAE on ``step``'s batch, whole."""
    from causal_gen_tpu_torch.parallel import spatial_sharding
    from causal_gen_tpu_torch.train.vae_trainer import preprocess_x

    model = build_hvae(cfg)
    batch = {"x": torch.from_numpy(step["x"]), "pa": torch.from_numpy(step["pa"])}
    noise = [torch.from_numpy(e) for e in step["noise"][0]]
    if mesh is not None:
        batch = shard_batch_spatial(mesh, batch)
        noise = [torch.from_numpy(rank_rows(mesh, e.numpy())) for e in noise]
    with torch.no_grad():
        zs = model.abduct(preprocess_x(batch["x"]), batch["pa"], noise=iter(noise), mesh=mesh)
    if mesh is None:
        return [z.numpy() for z in zs]
    return gather_latents(mesh, spatial_sharding(mesh), zs, cfg)


def sp_forward(cfg: Config, step, mesh=None) -> Dict[str, float]:
    """ELBO terms of a seeded HVAE's forward outside autograd (where a
    light block takes K2; counted), under ``mesh`` on this rank's part and
    averaged over ``data``."""
    from causal_gen_tpu_torch.models import blocks
    from causal_gen_tpu_torch.train.vae_trainer import preprocess_x

    model = build_hvae(cfg)
    batch = {"x": torch.from_numpy(step["x"]), "pa": torch.from_numpy(step["pa"])}
    noise = [torch.from_numpy(e) for e in step["noise"][0]]
    if mesh is not None:
        batch = shard_batch_spatial(mesh, batch)
        noise = [torch.from_numpy(rank_rows(mesh, e.numpy())) for e in noise]
    k2 = blocks.fused_light_block
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return k2(*a, **k)

    blocks.fused_light_block = counted
    try:
        with torch.inference_mode():
            out = model(preprocess_x(batch["x"]).float(), batch["pa"], noise=iter(noise),
                        train=False, mesh=mesh)
    finally:
        blocks.fused_light_block = k2
    if mesh is not None:
        out = mesh.reduce_metrics({k: out[k] for k in ("elbo", "nll", "kl")})
    return {**{k: float(out[k]) for k in ("elbo", "nll", "kl")}, "k2_calls": calls[0]}


def vol3d_cfg(**kw) -> Config:
    """tests/test_hvae3d.py::tiny3d_cfg on the port."""
    base = dict(input_res=8, bs=4, dtype="float32", enc_arch="8b1d2,4b1d4,1b1",
                dec_arch="1b1,4b2,8b1", widths=(8, 16, 32), z_dim=4, bias_max_res=4)
    base.update(kw)
    return get_config("vol3d32", **base)


def light_cfg(**kw) -> Config:
    """tiny_cfg with light blocks: K2 covers its residual 3x3 blocks."""
    return tiny_cfg(block_version="light", **kw)


def sp_cases():
    """(name, config, inputs) of the spatial checks."""
    return [(name, cfg, hvae_inputs(cfg, 2, seed=7))
            for name, cfg in (("tiny", tiny_cfg(lr_warmup_steps=0)),
                              ("light", light_cfg(lr_warmup_steps=0)), ("vol3d", vol3d_cfg()))]


def run_sp_checks(mesh=None, tp_mesh=None) -> Dict[str, Any]:
    """The spatial checks (``sp_cases``) under ``mesh``, and the tiny HVAE's
    steps under ``tp_mesh`` (``model`` and ``space`` at once) as "tiny_tp"."""
    out = {}
    for name, cfg, steps in sp_cases():
        out[name] = {"steps": run_hvae_steps(cfg, steps, mesh, spatial=True),
                     "forward": sp_forward(cfg, steps[0], mesh),
                     "loss_grads": hvae_loss_grads(cfg, steps[0], mesh, 10**9, spatial=True)}
        if name != "vol3d":
            out[name]["abduct"] = sp_abduct(cfg, steps[0], mesh)
        if name == "tiny":
            out["tiny_tp"] = {"steps": run_hvae_steps(cfg, steps, tp_mesh or mesh,
                                                      tp_min=TP_MIN, spatial=True),
                              "loss_grads": hvae_loss_grads(cfg, steps[0], tp_mesh or mesh,
                                                            spatial=True)}
    return out


def sp_rank(rank: int, world: int, device) -> Dict[str, Any]:
    return run_sp_checks(make_mesh((world // 2, 2), ("data", "space")),
                         make_mesh((1, 2, world // 2), ("data", "model", "space")))


# ---- helpers and collectives -------------------------------------------------

def helpers_rank(rank: int, world: int, device) -> Dict[str, Any]:
    """The distributed helpers and the differentiable collectives on a
    (2 ``data``, 2 ``space``) mesh of 4 ranks, each check's result as numpy."""
    from causal_gen_tpu_torch.parallel import (
        batch_sharding,
        host_shard_indices,
        make_global_batch,
        replicate,
        spatial_sharding,
    )

    mesh = make_mesh((2, 2), ("data", "space"))
    out: Dict[str, Any] = {"coords": mesh.coords,
                           "neighbours": [mesh.neighbour("space", -1), mesh.neighbour("space", 1)]}
    idx = np.arange(10, 26)
    out["host_shard"] = host_shard_indices(idx, mesh)
    out["host_shard_world"] = host_shard_indices(idx)
    local = {"x": np.arange(2 * 3 * 4 * 1, dtype=np.uint8).reshape(2, 3, 4, 1) + rank,
             "pa": np.full((2, 5), rank, np.float32)}
    b = make_global_batch(mesh, local, device)
    out["global_batch"] = {k: v.cpu().numpy() for k, v in b.items()}
    out["rows_accu2"] = batch_sharding(mesh, 8, microbatches=2)
    t = [torch.full((3,), float(rank)), torch.full((2, 2), float(rank))]
    out["replicated"] = [v.numpy() for v in replicate(t, mesh)]
    # the halo against rows of the whole tensor, forward and backward: each
    # space rank's term <widen(slab), C_s>, summed over the ranks, is f
    from causal_gen_tpu_torch.parallel.collectives import all_reduce_

    sp = spatial_sharding(mesh)
    g = torch.Generator().manual_seed(mesh.index("data"))  # alike along `space`
    whole = torch.randn(2, 3, 8, 5, generator=g)
    spans = [(max(0, 4 * i - 1), min(8, 4 * i + 5)) for i in range(sp.n)]
    cots = [torch.randn(2, 3, hi - lo, 5, generator=g) for lo, hi in spans]
    x = whole.clone().requires_grad_(True)
    ext = sp.widen(sp.slab(x), 1)
    lo, hi = spans[sp.index]
    out["halo_fwd_err"] = float((ext - whole[:, :, lo:hi]).abs().max())
    (ext * cots[sp.index]).sum().backward()
    grad = all_reduce_(x.grad.clone(), sp.group)
    y = whole.clone().requires_grad_(True)
    sum((y[:, :, a:b] * c).sum() for (a, b), c in zip(spans, cots)).backward()
    out["halo_grad_err"] = float((grad - y.grad).abs().max())
    out["gather_err"] = float((sp.gather(sp.slab(whole)) - whole).abs().max())
    return out
