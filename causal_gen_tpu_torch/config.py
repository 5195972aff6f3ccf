"""Typed hyperparameter system: a copy of ``causal_gen_tpu/config.py``.

The port keeps its own copy so that it imports nothing of the JAX package.
Every field, default and registry entry is the same, so an ``hparams.json``
written by the JAX trainer loads here with ``Config.from_dict``. ``remat``
and ``remat_min_res`` pick what the HVAE recomputes in the backward, and
``stage_scan`` (a scan layout in JAX; the port runs every block unrolled)
only picks the remat unit (see ``models/hvae.py``). Fields that only steer
the JAX programs (``use_pallas``, ``steps_per_call``, the mesh) are kept for
that reason and are not read by the port; the port's model classes raise on
the ones that would change the model it builds.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture DSL
# ---------------------------------------------------------------------------
# Encoder stage grammar (reference vae.py:90-113): "<res>b<blocks>[d<rate>]"
# e.g. "32b3d2" = at input-res 32 run 3 blocks then a downsampling block /2.
# Decoder stage grammar (reference vae.py:198-203): "<res>b<blocks>".


@dataclass(frozen=True)
class EncStage:
    res: int
    n_blocks: int
    down_rate: Optional[int]  # None = no downsample block at end of stage


@dataclass(frozen=True)
class DecStage:
    res: int
    n_blocks: int


def parse_enc_arch(enc_arch: str) -> Tuple[EncStage, ...]:
    stages = []
    for stage in enc_arch.split(","):
        res_s, rest = stage.split("b")
        if "d" in rest:
            nb_s, d_s = rest.split("d")
            down: Optional[int] = int(d_s)
        else:
            nb_s, down = rest, None
        stages.append(EncStage(res=int(res_s), n_blocks=int(nb_s), down_rate=down))
    return tuple(stages)


def parse_dec_arch(dec_arch: str) -> Tuple[DecStage, ...]:
    stages = []
    for stage in dec_arch.split(","):
        res_s, nb_s = stage.split("b")
        stages.append(DecStage(res=int(res_s), n_blocks=int(nb_s)))
    return tuple(stages)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Config:
    """Full experiment configuration (replaces reference src/hps.py registry).

    Field defaults mirror the reference argparse defaults (hps.py:94-254).
    """

    # experiment
    name: str = "ukbb64"
    exp_name: str = ""
    data_dir: str = ""
    seed: int = 7
    # training
    epochs: int = 5000
    bs: int = 32
    lr: float = 1e-3
    lr_warmup_steps: int = 100
    wd: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.9)
    ema_rate: float = 0.999
    input_res: int = 64
    input_channels: int = 1
    # 2 = NHWC images (the reference's domain); 3 = NDHWC volumes (cubic:
    # one `input_res` per side). The arch DSL is unchanged — stage "res"
    # means per-side resolution. No reference counterpart (strictly 2-D);
    # this is the TPU-native extension the spatial-sharding helpers target
    # (parallel/mesh.py::spatial_sharding).
    spatial_dims: int = 2
    pad: int = 3
    hflip: float = 0.5
    grad_clip: float = 350.0
    grad_skip: float = 500.0
    accu_steps: int = 1
    steps_per_call: int = 1  # optimizer steps per jitted dispatch (lax.scan);
    # amortizes host->device dispatch/transfer latency on remote/tunneled
    # backends without changing update semantics (see train/vae_trainer.py)
    beta: float = 1.0
    beta_warmup_steps: int = 0
    kl_free_bits: float = 0.0
    viz_freq: int = 10000
    eval_freq: int = 5
    ckpt_max_to_keep: int = 3  # async-writer rotation depth (best is immune)
    # model
    vae: str = "hierarchical"  # "simple" | "hierarchical"
    enc_arch: str = "64b1d2,32b1d2,16b1d2,8b1d8,1b2"
    dec_arch: str = "1b2,8b2,16b2,32b2,64b2"
    cond_prior: bool = False
    widths: Tuple[int, ...] = (16, 32, 48, 64, 128)
    bottleneck: int = 4
    z_dim: int = 16
    z_max_res: int = 192
    bias_max_res: int = 64
    x_like: str = "diag_dgauss"  # {fixed,shared,diag}_{gauss,dgauss,dmol}
    std_init: float = 0.0
    parents_x: Tuple[str, ...] = ("mri_seq", "brain_volume", "ventricle_volume", "sex")
    concat_pa: bool = True
    context_dim: int = 4
    context_norm: str = "log_standard"  # "[-1,1]" | "[0,1]" | "log_standard"
    corrupt_p: float = 0.0  # cmnist label-corruption fraction (datasets.py:325)
    q_correction: bool = False
    # init scale of each posterior head's last conv. The reference leaves it
    # at the default init (vae.py only zero-inits the PRIOR head, :308); 1.0
    # reproduces that. 0.0 zero-inits the posterior too, so q == p == N(0,1)
    # at init and the initial KL is exactly 0 — the 3-D volumetric stack
    # needs this: with 27-tap convs and no normalization, some init draws
    # otherwise land at init KL ~80 nats/voxel and every update trips the
    # grad_skip gate (run deadlocks at init).
    posterior_init_scale: float = 1.0
    # block body variant: "gelu6" (4-conv GELU body) or "light" (2-conv ReLU,
    # lower memory; reference vae.py:49-68 keys this off the dataset name)
    block_version: Optional[str] = None
    # conditioning dropout: zero parent channels [cond_drop_from:] on a random
    # path during cond_prior training (reference vae.py:220,244-249 keys this
    # off 'morphomnist' in the hps name; we make it explicit config)
    cond_drop_from: Optional[int] = None
    # compute
    dtype: str = "float32"  # activations dtype for conv stacks
    use_pallas: bool = False  # fuse hot elementwise chains with Pallas kernels
    remat: bool = False  # rematerialize conv blocks (memory <-> FLOPs trade)
    # selective remat: only rematerialize blocks at resolution >= this.
    # Activation memory scales with res^2 * width (the 192^2/96^2 stages of
    # ukbb192 dominate it), so checkpointing ONLY the high-res stages keeps
    # nearly all of remat's memory win while skipping the recompute of the
    # FLOPs-heavy low-res stages. 0 = remat everything (round-1 behavior).
    remat_min_res: int = 0
    # lax.scan over runs of same-shaped decoder blocks: one traced/compiled
    # body per run instead of a full Python unroll, cutting big-config
    # compile times; param layout changes (stacked leading axis) — see
    # models/hvae.py::migrate_decoder_params for old-checkpoint migration.
    # With remat=True the scan body is the rematerialization unit
    # (stage-level jax.checkpoint).
    stage_scan: bool = False
    # round every conv width up to a multiple of this (0 = off). TPU lanes are
    # 128-wide; narrow channel dims underfill the MXU. Changes model capacity,
    # so it is OFF for parity configs and opt-in for perf variants.
    width_multiple: int = 0
    # parallelism (no reference counterpart; see SURVEY.md parallelism table),
    # carried as the JAX package carries them and read by nothing there or
    # here: a run builds its mesh with parallel/mesh.py::make_mesh(shape, axes)
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)

    # ---- derived, static structure -------------------------------------
    @property
    def model_widths(self) -> Tuple[int, ...]:
        """Conv stage widths after optional lane-friendly rounding."""
        if self.width_multiple <= 0:
            return self.widths
        m = self.width_multiple
        return tuple(-(-w // m) * m for w in self.widths)

    @property
    def enc_stages(self) -> Tuple[EncStage, ...]:
        return parse_enc_arch(self.enc_arch)

    @property
    def dec_stages(self) -> Tuple[DecStage, ...]:
        return parse_dec_arch(self.dec_arch)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        clean = {}
        fields = {f.name: f for f in dataclasses.fields(Config)}
        for k, v in d.items():
            if k not in fields:
                continue
            if isinstance(v, list):
                v = tuple(v)
            clean[k] = v
        return Config(**clean)


# ---------------------------------------------------------------------------
# Registry (reference src/hps.py:12-78)
# ---------------------------------------------------------------------------

CONFIG_REGISTRY: Dict[str, Config] = {}


def register(name: str, **overrides: Any) -> Config:
    cfg = Config(name=name).replace(**overrides)
    CONFIG_REGISTRY[name] = cfg
    return cfg


register(
    "morphomnist",
    lr=1e-3,
    bs=32,
    wd=0.01,
    z_dim=16,
    input_res=32,
    pad=4,
    enc_arch="32b3d2,16b3d2,8b3d2,4b3d4,1b4",
    dec_arch="1b4,4b4,8b4,16b4,32b4",
    widths=(16, 32, 64, 128, 256),
    parents_x=("thickness", "intensity", "digit"),
    concat_pa=True,
    context_norm="[-1,1]",
    context_dim=12,
    block_version=None,  # GELU 4-conv body (reference vae.py:57-68)
    cond_drop_from=2,  # drop digit one-hot channels only (reference vae.py:246)
)

register(
    "cmnist",
    lr=1e-3,
    bs=32,
    wd=0.01,
    z_dim=16,
    input_res=32,
    input_channels=3,
    pad=4,
    enc_arch="32b3d2,16b3d2,8b3d2,4b3d4,1b4",
    dec_arch="1b4,4b4,8b4,16b4,32b4",
    widths=(16, 32, 64, 128, 256),
    parents_x=("digit", "colour"),
    context_dim=20,
)

register(
    "ukbb64",
    lr=1e-3,
    bs=32,
    wd=0.1,
    z_dim=16,
    input_res=64,
    pad=3,
    enc_arch="64b3d2,32b31d2,16b15d2,8b7d2,4b3d4,1b2",
    dec_arch="1b2,4b4,8b8,16b16,32b32,64b4",
    widths=(32, 64, 128, 256, 512, 1024),
    block_version="light",  # reference vae.py:428 keys this off 'ukbb'
)

register(
    "ukbb192",
    lr=1e-3,
    bs=32,
    wd=0.1,
    z_dim=16,
    input_res=192,
    pad=9,
    enc_arch="192b1d2,96b3d2,48b7d2,24b11d2,12b7d2,6b3d6,1b2",
    dec_arch="1b2,6b4,12b8,24b12,48b8,96b4,192b2",
    widths=(32, 64, 96, 128, 160, 192, 512),
    block_version="light",
    # wide 192² stacks win from bf16 convs (measured 1.43x on v5e);
    # distribution math stays f32 — pass dtype="float32" for strict parity
    dtype="bfloat16",
)

register(
    "mimic192",
    lr=1e-3,
    bs=16,
    wd=0.1,
    z_dim=16,
    input_res=192,
    pad=9,
    enc_arch="192b1d2,96b3d2,48b7d2,24b11d2,12b7d2,6b3d6,1b2",
    dec_arch="1b2,6b4,12b8,24b12,48b8,96b4,192b2",
    widths=(32, 64, 96, 128, 160, 192, 512),
    # reference launch config (run_slurm.sh:44-45): age + race(one-hot 3) +
    # sex + finding = context_dim 6; attrs are pre-normalized when the dataset is built
    parents_x=("age", "race", "sex", "finding"),
    context_dim=6,
    dtype="bfloat16",  # see ukbb192 note
)


register(
    # 3-D volumetric HVAE demo: synthetic spheres with causal parents
    # (radius, intensity) — the volumetric analog of the Morpho-MNIST
    # (thickness, intensity) mechanism. No reference counterpart.
    "vol3d32",
    lr=1e-3,
    bs=8,
    wd=0.01,
    z_dim=8,
    input_res=32,
    spatial_dims=3,
    pad=0,
    hflip=0.0,
    enc_arch="32b2d2,16b2d2,8b2d2,4b2d4,1b2",
    dec_arch="1b2,4b2,8b2,16b2,32b2",
    widths=(8, 16, 32, 48, 64),
    block_version="light",  # 2-conv body: 3-D convs are 3x the taps
    # zero-init posterior heads: q == p == N(0,1) at init so initial KL is 0.
    # Without it some init draws start at ~80 nats/voxel KL and every update
    # trips grad_skip (measured; see Config.posterior_init_scale)
    posterior_init_scale=0.0,
    parents_x=("radius", "intensity"),
    context_dim=2,
    context_norm="[-1,1]",
    bias_max_res=8,  # biases are r^3 tensors; cap them low
    x_like="diag_dgauss",
    dtype="bfloat16",
)


def get_config(name: str, **overrides: Any) -> Config:
    if name not in CONFIG_REGISTRY:
        raise KeyError(f"unknown config '{name}'; have {sorted(CONFIG_REGISTRY)}")
    cfg = CONFIG_REGISTRY[name]
    return cfg.replace(**overrides) if overrides else cfg
