"""Spatial sharding of the HVAE's activations over the mesh's ``space`` axis.

JAX shards dim 1 of NHWC / NDHWC over ``space`` and GSPMD writes the halo
exchanges and gathers (``causal_gen_tpu/parallel/mesh.py:56-93``). Here the
model code does it, through a ``SpatialShard`` that ``models/blocks.py`` and
``models/hvae.py`` take (``mesh=`` of ``HVAE.forward`` / ``abduct``):

- dim 2 of NCHW / NCDHW (H of an image, D of a volume) is split into equal
  slabs, one a ``space`` rank, in rank order;
- the plan (``sharded``): a resolution r is sharded when it splits into
  slabs of an even number (at least 2) of rows, r % (2 n) == 0 for n ranks.
  Every other resolution (the low-resolution stages, an odd one that the
  encoder pads) is whole and computed alike on every ``space`` rank, as XLA
  gathers the stages smaller than the mesh. The rule is monotone: a
  resolution that an upsample or pool reaches from a sharded one by an
  integer factor up is sharded too;
- a 3x3 conv (a 7x7 stem) takes ``k // 2`` rows from each neighbour
  (``collectives.halo``) and runs with no padding along the split dim; the
  image's borders keep their zero padding;
- K2 (the fused light block, two 3x3 convs) takes two rows from each
  neighbour, runs on the widened slab and is cropped back to the rank's rows;
- a pool runs on the slab when its output is sharded (the slab's rows then
  divide by the rate), else on the gathered tensor; an upsample runs on the
  slab, or on the whole tensor and is then cut to the slab where a whole
  resolution meets a sharded one;
- the per-image NLL and each block's spatial KL sum are summed over
  ``space`` (``sum``), so every ``space`` rank holds the whole image's;
- the injected draws of a sharded block come at the block's whole
  resolution and each rank takes its slab; drawn from a generator, they are
  drawn whole (every ``space`` rank's generator is alike) and cut, so that
  the ranks' slabs are one draw of the whole map.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from causal_gen_tpu_torch.ops.distributions import draw
from causal_gen_tpu_torch.parallel.collectives import all_gather, all_reduce_sum, halo
from causal_gen_tpu_torch.parallel.tensor import conv_padded


class SpatialShard:
    """This rank's slab of dim 2 over the mesh's ``axis`` (``n`` ranks)."""

    def __init__(self, mesh, axis: str = "space"):
        self.n = mesh.size(axis)
        self.index = mesh.index(axis)
        self.group = mesh.group(axis)
        self.prev = mesh.neighbour(axis, -1)
        self.next = mesh.neighbour(axis, 1)

    def sharded(self, res: int) -> bool:
        """Whether activations at resolution ``res`` are split (the plan)."""
        return res % (2 * self.n) == 0

    def at(self, res: int) -> Optional["SpatialShard"]:
        """``self`` where ``res`` is sharded, else None (whole tensors)."""
        return self if self.sharded(res) else None

    def slab(self, t: Tensor) -> Tensor:
        """This rank's rows of a whole tensor."""
        rows = t.shape[2] // self.n
        return t.narrow(2, self.index * rows, rows)

    def gather(self, t: Tensor) -> Tensor:
        """The whole tensor from every rank's slab (differentiable)."""
        return all_gather(t.contiguous(), 2, self.group)

    def sum(self, t: Tensor) -> Tensor:
        """The sum of ``t`` over the ``space`` ranks (differentiable)."""
        return all_reduce_sum(t, self.group)

    def widen(self, x: Tensor, rows: int) -> Tensor:
        """The slab with ``rows`` rows of each neighbour (none at a border)."""
        return halo(x.contiguous(), rows, 2, self.prev, self.next, self.group)

    def crop(self, y: Tensor, rows: int, n: int) -> Tensor:
        """The rank's ``n`` rows of a result on a slab widened by ``rows``."""
        return y.narrow(2, rows if self.prev is not None else 0, n)

    def conv(self, conv: nn.Module, x: Tensor, weight: Tensor, bias: Optional[Tensor]
             ) -> Tensor:
        """``conv`` (stride 1, odd kernel) on the slab ``x``: a halo of k // 2
        rows, zero rows at the image's borders, no padding along dim 2."""
        p = conv.padding[0]
        if conv.stride[0] != 1 or x.shape[2] < p:
            raise ValueError(f"spatial conv: stride {conv.stride} on {x.shape[2]} rows")
        x = self.widen(x, p)
        border = (p if self.prev is None else 0, p if self.next is None else 0)
        x = F.pad(x, (0, 0) * (x.dim() - 3) + border)
        return conv_padded(conv, x, weight, bias, (0,) + tuple(conv.padding[1:]))

    def noise(self, eps: Optional[Tensor], like: Tensor,
              generator: Optional[torch.Generator]) -> Tensor:
        """This rank's slab of a draw for a map shaped like the slab
        ``like``: of ``eps`` (the whole map's), or of a whole map drawn from
        ``generator`` (see the module docstring)."""
        if eps is None:
            shape = like.shape[:2] + (like.shape[2] * self.n,) + like.shape[3:]
            eps = draw(torch.randn, shape, generator, like.device, like.dtype)
        return self.slab(eps).contiguous()
