"""Conv building blocks of the HVAE image mechanism (PyTorch, NCHW).

Counterpart of ``causal_gen_tpu/models/blocks.py``: ``Block`` (reference
src/vae.py:33-84), ``Encoder`` (vae.py:87-134) and ``upsample_nearest``.
Submodules carry flax's auto-generated names (``Conv_0``, ``width_proj``,
``blocks_3``, ...) so that a converted flax parameter tree loads as a
``state_dict`` key for key (see ``convert.py``). ``spatial_dims=3`` builds
the same modules over NCDHW volumes: ``Conv3d``, ``avg_pool3d``, the odd-size
pad and the upsample over every spatial axis (causal_gen_tpu/models/blocks.py
takes the same field).

Padding: flax "SAME" for an odd kernel at stride 1 is ``k // 2`` on every side,
which is what ``make_conv`` sets.

Compute dtype: with ``dtype=torch.bfloat16`` the parameters stay float32 and
each conv casts its input, weight and bias to bf16 and returns bf16, as
flax's ``nn.Conv(dtype=...)`` does (``conv_in``).

Parallelism (``parallel/``): a conv that ``shard_params_tp`` made
column-parallel computes its shard of the out channels and gathers them;
K2 takes its gathered weights. ``sp``, a ``parallel/spatial.py::
SpatialShard``, is given to ``conv_in``, ``Block`` and ``Encoder`` when the
input is spatially sharded: each kxk conv takes its halo, K2 a two-row
halo, and a pool whose output resolution is whole gathers first.

Remat: a ``Block`` with ``remat`` set runs under the non-reentrant
``torch.utils.checkpoint`` where autograd records, as flax's ``nn.remat(Block)``
(``models/remat.py``). The ``Encoder`` sets it on each block whose input
resolution is at least ``remat_min_res`` (causal_gen_tpu/models/blocks.py:
126-130); ``models/hvae.py`` on the decoder's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from causal_gen_tpu_torch.models.remat import checkpointed
from causal_gen_tpu_torch.ops.fused_block import fused_light_block
from causal_gen_tpu_torch.parallel.tensor import full_weight

# flax's lecun_normal draws a normal truncated at +-2 std, rescaled by this
# constant so that the truncated draw keeps unit variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: Tensor, generator: Optional[torch.Generator], scale: float = 1.0,
                  fan_in: Optional[int] = None) -> None:
    """In place: flax's lecun_normal times ``scale``. The fan-in defaults to
    that of an OIHW or (out, in) torch kernel."""
    fan_in = w[0].numel() if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        w.mul_(scale)


def init_params(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialise ``module`` as flax initialises its counterpart: lecun-normal
    conv/dense kernels, zero biases, unit norm scales; then each submodule with
    an ``init_extra_`` method applies its own rule (a scaled or zero last conv,
    a lecun-normal parameter that is not a layer's)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    for m in module.modules():
        if hasattr(m, "init_extra_"):
            m.init_extra_(generator)
    return module


def make_conv(cin: int, cout: int, k: int, spatial_dims: int = 2, **kw) -> nn.Module:
    """A ``k``-wide conv over ``spatial_dims`` axes (``Conv2d`` or ``Conv3d``),
    padded as flax pads an odd kernel at stride 1 ("SAME")."""
    cls = {2: nn.Conv2d, 3: nn.Conv3d}[spatial_dims]
    return cls(cin, cout, k, padding=k // 2, **kw)


def _cast(t: Optional[Tensor], dtype: Optional[torch.dtype]) -> Optional[Tensor]:
    return t if t is None or dtype is None else t.to(dtype)


def conv_in(conv: nn.Module, x: Tensor, dtype: Optional[torch.dtype], sp=None) -> Tensor:
    """``conv(x)`` in the compute ``dtype`` (None: as the tensors come): input,
    weight and bias cast, output in ``dtype``. With ``sp`` (x a spatial
    slab) a kxk conv takes its halo (``SpatialShard.conv``)."""
    if sp is not None and conv.padding[0] > 0:
        return sp.conv(conv, x if dtype is None else x.to(dtype), _cast(conv.weight, dtype),
                       _cast(conv.bias, dtype))
    if dtype is None:
        return conv(x)
    return conv._conv_forward(x.to(dtype), conv.weight.to(dtype), _cast(conv.bias, dtype))


class Block(nn.Module):
    """Bottlenecked residual conv block (reference vae.py:33-84).

    version=None: GELU 1x1 -> kxk -> kxk -> 1x1 body ("morphomnist" variant),
    with exact erf GELU. version="light": ReLU kxk -> kxk two-conv body.

    K2 (``ops/fused_block.py``) computes the whole body of a block it covers:
    2-D, ``version="light"``, residual, kernel size 3 and no ``width_proj`` (in
    width == out width); a ``down_rate`` block of that kind takes K2, then
    the average pool. The block takes K2 when it covers it, autograd is not
    recording (``torch.is_grad_enabled()`` is False, as under
    ``torch.inference_mode()``: K2 has no gradient, as in JAX) and x comes in
    the compute dtype; the kernel on CUDA, its plain version on the CPU.
    Otherwise it runs its convs one by one (every training step does).

    ``remat`` (set after construction; it holds no parameter) recomputes the
    block in the backward instead of keeping its activations. The first run
    records under autograd, so a rematerialised block never takes K2 there.
    """

    def __init__(self, in_width: int, bottleneck: int, out_width: int,
                 kernel_size: int = 3, residual: bool = True,
                 down_rate: Optional[int] = None, version: Optional[str] = None,
                 last_scale: float = 1.0, dtype: Optional[torch.dtype] = None,
                 spatial_dims: int = 2):
        super().__init__()
        k = kernel_size
        nd = spatial_dims
        self.spatial_dims = nd
        self.version = version
        self.dtype = dtype
        self.residual = residual
        self.down_rate = down_rate
        self.last_scale = last_scale
        if version == "light":
            plan = [(in_width, bottleneck, k), (bottleneck, out_width, k)]
        else:
            plan = [(in_width, bottleneck, 1), (bottleneck, bottleneck, k),
                    (bottleneck, bottleneck, k), (bottleneck, out_width, 1)]
        convs = [make_conv(cin, cout, kk, nd) for cin, cout, kk in plan]
        for i, c in enumerate(convs):
            self.add_module(f"Conv_{i}", c)
        self._convs = convs
        # width projection exists when downsampling or narrowing (vae.py:70-71)
        if residual and in_width != out_width:
            self.width_proj = make_conv(in_width, out_width, 1, nd)
        else:
            self.width_proj = None
        # K2 is the 2-D 3x3 body (causal_gen_tpu/ops/fused_block.py:190); a
        # 3-D light block runs its Conv3d pair
        self.k2_covered = (nd == 2 and version == "light" and residual and k == 3
                           and self.width_proj is None)
        self.remat = False

    def init_extra_(self, generator: Optional[torch.Generator]) -> None:
        last = self._convs[-1].weight
        if self.last_scale == 0.0:
            nn.init.zeros_(last)
        else:
            lecun_normal_(last, generator, self.last_scale)

    def takes_k2(self, x: Tensor) -> bool:
        """Whether ``forward(x)`` runs K2 (see the class docstring)."""
        return (self.k2_covered and not torch.is_grad_enabled()
                and x.dtype == (self.dtype or torch.float32))

    def forward(self, x: Tensor, sp=None) -> Tensor:
        """The block on ``x``; with ``sp``, x is this rank's spatial slab."""
        if self.remat:
            return checkpointed(self._body, x, sp)
        return self._body(x, sp)

    def _body(self, x: Tensor, sp=None) -> Tensor:
        dt = self.dtype
        if self.takes_k2(x):
            c1, c2 = self._convs
            xin = x.contiguous() if sp is None else sp.widen(x, 2)
            out = fused_light_block(xin, full_weight(c1).to(x.dtype), full_weight(c2).to(x.dtype),
                                    _cast(c1.bias, x.dtype), _cast(c2.bias, x.dtype))
            if sp is not None:
                out = sp.crop(out, 2, x.shape[2])
        else:
            act = F.relu if self.version == "light" else (
                lambda v: F.gelu(v, approximate="none"))
            out = x
            for c in self._convs:
                out = conv_in(c, act(out), dt, sp)
            if self.residual:
                if self.width_proj is not None:
                    x = conv_in(self.width_proj, x, dt)
                out = x + out
        if self.down_rate:
            d = self.down_rate
            if sp is not None and not sp.sharded(out.shape[2] * sp.n // d):
                out = sp.gather(out)
            if self.spatial_dims == 2:
                out = F.avg_pool2d(out, d, d)
            else:  # PyTorch's CPU avg_pool3d has no bf16: pool in float32, round once
                out = F.avg_pool3d(out.float(), d, d).to(out.dtype)
        return out


class Encoder(nn.Module):
    """Bottom-up encoder producing activations keyed by spatial resolution
    (reference vae.py:87-134). With ``remat`` each block whose input
    resolution (its stage's) is at least ``remat_min_res`` is rematerialised."""

    def __init__(self, stages: Tuple, widths: Tuple[int, ...], bottleneck: int,
                 input_channels: int, version: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, spatial_dims: int = 2,
                 remat: bool = False, remat_min_res: int = 0):
        super().__init__()
        self.dtype = dtype
        self.spatial_dims = spatial_dims
        flat = []
        stem_width, stem_stride = widths[0], 1
        for i, stage in enumerate(stages):
            if i == 0 and stage.n_blocks == 0 and stage.down_rate is None:
                stem_width, stem_stride = widths[1], 2
                continue
            flat += [(widths[i], None, stage.res) for _ in range(stage.n_blocks)]
            if stage.down_rate is not None:
                flat += [(widths[i + 1], stage.down_rate, stage.res)]
        self.stem = make_conv(input_channels, stem_width, 7, spatial_dims, stride=stem_stride)
        self._in_res = stages[0].res
        self._down_rates = [d for _, d, _ in flat]
        n = len(flat)
        blocks = []
        for i, (width, d, res) in enumerate(flat):
            prev_width = flat[max(0, i - 1)][0]
            blocks.append(Block(prev_width, prev_width // bottleneck, width, down_rate=d,
                                version=version, last_scale=float(math.sqrt(1.0 / n)),
                                dtype=dtype, spatial_dims=spatial_dims))
            blocks[-1].remat = remat and res >= remat_min_res
            self.add_module(f"blocks_{i}", blocks[-1])
        self._blocks = blocks

    def forward(self, x: Tensor, sp=None) -> Dict[int, Tensor]:
        """Activations by resolution. With ``sp`` (a ``SpatialShard``), x and
        each activation are this rank's slab where the plan shards their
        resolution, else whole."""
        stride = self.stem.stride[0]
        stem_sp = sp and sp.at(self._in_res)
        if stem_sp is not None and (stride > 1 or x.shape[2] < self.stem.padding[0]):
            # no halo conv on a strided or short slab: the stem on the whole image
            x = conv_in(self.stem, sp.gather(x), self.dtype)
            x = sp.slab(x) if sp.sharded(x.shape[2]) else x
        else:
            x = conv_in(self.stem, x, self.dtype, stem_sp)
        acts: Dict[int, Tensor] = {}
        # whole tensors show their resolution (an input may differ from the
        # stages'); a slab does not, so under sp the stages give it
        res = x.shape[2] if sp is None else (self._in_res - 1) // stride + 1
        for block, d in zip(self._blocks, self._down_rates):
            x = block(x, sp and sp.at(res))
            res = res // d if d else res
            if res % 2 and res > 1:  # pad odd resolutions (reference vae.py:131-132)
                x = F.pad(x, (0, 1) * self.spatial_dims)
                res += 1
                if sp is not None and sp.sharded(res):
                    x = sp.slab(x)
            acts[res] = x
        return acts


def upsample_nearest(x: Tensor, target_res: int) -> Tensor:
    """Nearest-neighbour upsample of every spatial axis of NC(D)HW to
    ``target_res`` by an integer factor (F.interpolate(mode='nearest'),
    reference vae.py:253, 259)."""
    h = x.shape[2]
    if target_res == h:
        return x
    if target_res % h:
        raise ValueError(f"upsample_nearest: {h} -> {target_res} is not an integer factor")
    f = target_res // h
    for dim in range(2, x.dim()):
        x = x.repeat_interleave(f, dim=dim)
    return x
