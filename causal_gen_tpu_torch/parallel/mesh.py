"""The device mesh and the placement of batches and parameters on it.

Counterpart of ``causal_gen_tpu/parallel/mesh.py``. There, a ``Mesh`` of
devices, ``NamedSharding`` annotations, and GSPMD inserting the collectives.
Here every process is one rank (one device) of ``torch.distributed``; the
ranks are laid out row-major over the mesh's ``shape`` and ``axes``
(``data``, ``model``, ``space``), and a ``Mesh`` holds a process group for
each set of axes. Each rank holds its own part of every array:

- a batch: the rows of its ``data`` coordinate (``shard_batch``); with
  ``space``, image rows of its ``space`` coordinate as well
  (``shard_batch_spatial``, ``parallel/spatial.py``);
- the parameters: replicated (``replicate``: rank 0's broadcast), or with
  ``model``, a wide conv or dense layer's shard of its out channels
  (``shard_params_tp``, ``parallel/tensor.py``).

The train steps (``train/vae_trainer.py``, ``pgm/train_pgm.py``,
``pgm/train_cf.py``) take a ``Mesh`` and then reduce what GSPMD reduced:

- every rank differentiates its own copy of the loss; a batch-level
  quantity that needs the whole batch (the free-bits clamp of the batch-mean
  KL, the CF Lagrangian's batch-mean ELBO) is all-reduced inside autograd
  (``mean``), and every collective's backward is its exact adjoint
  (``parallel/collectives.py``);
- so the rank copies' sum is the one-process loss times the number of
  copies, and ``reduce_gradients`` sums each gradient over the ranks that
  hold its parameter and divides by that number: the world size for a
  batch-mean loss, the world size over the ``data`` size for a batch-sum
  loss (the semi-supervised PGM loss), whose copies along ``data`` add up;
- ``grad_norm`` counts each parameter once: the sharded ones' squares are
  summed over ``model``, the replicated ones' are not counted again;
- ``reduce_metrics`` gives the global metrics (a mean, or a sum, over
  ``data``), so every rank takes the same skip decision.

Gradients are reduced explicitly after the microbatch loop, not by DDP: one
all-reduce per step whatever ``accu_steps`` is (DDP would need ``no_sync``
in the loop), the divisor follows the loss (DDP only averages), and the
sharded weights reduce over another group than the replicated ones.
"""

from __future__ import annotations

import copy
import itertools
import math
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor, nn

from causal_gen_tpu_torch.parallel.collectives import (
    all_reduce_,
    all_reduce_sum,
    broadcast_,
    flat_all_reduce_,
)
from causal_gen_tpu_torch.parallel.tensor import make_column_parallel, sharded_parameters

AXES = ("data", "model", "space")


class Mesh:
    """The ranks of ``torch.distributed`` (or one process without it) as a
    grid of ``shape`` over the named ``axes``, with a process group for every
    set of axes. An axis the mesh lacks has size 1 and index 0. Every rank
    builds its ``Mesh`` with the same arguments (``new_group`` is
    collective). A deep copy of a module that holds the mesh shares it."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
        if not set(axes) <= set(AXES):
            raise ValueError(f"mesh axes {axes}: each must be one of {AXES}")
        on = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if on else 1
        self.rank = dist.get_rank() if on else 0
        if math.prod(shape) != self.world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} has {math.prod(shape)} ranks; "
                             f"the process group has {self.world}")
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.axis_names = axes
        self.coords: Dict[str, int] = {
            a: int(c) for a, c in zip(axes, np.unravel_index(self.rank, shape))}
        self._grid = np.arange(self.world).reshape(shape)
        self._groups: Dict[Tuple[str, ...], Any] = {}
        for k in range(1, len(axes) + 1):
            for sub in itertools.combinations(axes, k):
                self._groups[sub] = self._new_group(sub)

    def _new_group(self, sub: Tuple[str, ...]):
        size = math.prod(self.shape[a] for a in sub)
        if size == 1:
            return None
        if size == self.world:
            return dist.group.WORLD
        order = [self.axis_names.index(a) for a in self.axis_names if a not in sub] + [
            self.axis_names.index(a) for a in sub]
        mine = None
        for ranks in self._grid.transpose(order).reshape(-1, size):
            group = dist.new_group([int(r) for r in ranks])
            if self.rank in ranks:
                mine = group
        return mine

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"

    def only(self, *axes: str) -> "Mesh":
        """This mesh as a computation split along ``axes`` alone sees it:
        the other axes are dropped (size 1), their ranks computing alike;
        the process groups are this mesh's."""
        view = copy.copy(self)
        view.axis_names = tuple(a for a in self.axis_names if a in axes)
        view.shape = {a: self.shape[a] for a in view.axis_names}
        view.coords = {a: self.coords[a] for a in view.axis_names}
        return view

    def size(self, *axes: str) -> int:
        """The number of ranks along ``axes`` (1 for an axis the mesh lacks)."""
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only
        along ``axes``; None when it is this rank alone."""
        return self._groups.get(tuple(a for a in self.axis_names if a in axes))

    def neighbour(self, axis: str, step: int) -> Optional[int]:
        """The global rank ``step`` along ``axis`` from this one, or None
        past the mesh's edge."""
        i = self.index(axis) + step
        if axis not in self.shape or not 0 <= i < self.shape[axis]:
            return None
        coords = dict(self.coords, **{axis: i})
        return int(self._grid[tuple(coords[a] for a in self.axis_names)])

    def origin(self, axes: Sequence[str]) -> int:
        """The global rank at index 0 along ``axes`` and at this rank's
        index along the others."""
        coords = dict(self.coords, **{a: 0 for a in axes if a in self.shape})
        return int(self._grid[tuple(coords[a] for a in self.axis_names)])

    def replica_axes(self, sharded: bool) -> Tuple[str, ...]:
        """The axes along which a parameter is replicated: all of them, or
        all but ``model`` for a tensor-parallel shard."""
        return tuple(a for a in self.axis_names if not (sharded and a == "model"))

    def generator(self, seed: int) -> torch.Generator:
        """A CPU generator seeded from (``seed``, this rank's ``data``
        index): the ranks that share a batch's rows (along ``model`` and
        ``space``) draw alike, and each ``data`` shard draws its own stream,
        which is another stream than one process draws (not a fault)."""
        state = np.random.SeedSequence([seed, self.index("data")]).generate_state(1)[0]
        return torch.Generator().manual_seed(int(state))

    def mean(self, t: Tensor, axis: str = "data") -> Tensor:
        """The mean of ``t`` over ``axis``, differentiable (each rank's
        ``t`` a mean over as many rows)."""
        n = self.size(axis)
        return t if n == 1 else all_reduce_sum(t, self.group(axis)) / n

    def reduce_gradients(self, params: Iterable[Tensor], sharded: frozenset = frozenset(),
                         batch_sum: bool = False) -> None:
        """In place: each gradient summed over the ranks that hold its
        parameter and divided by the loss's number of copies (the module
        docstring). ``sharded`` holds the ids of tensor-parallel shards."""
        params = [p for p in params if p.grad is not None]
        copies = self.world // (self.size("data") if batch_sum else 1)
        for is_shard in (False, True):
            grads = [p.grad for p in params if (id(p) in sharded) == is_shard]
            flat_all_reduce_(grads, self.group(*self.replica_axes(is_shard)))
            if copies > 1 and grads:
                torch._foreach_mul_(grads, 1.0 / copies)

    def grad_norm(self, params: Iterable[Tensor], sharded: frozenset = frozenset()) -> Tensor:
        """The global norm of the reduced gradients, each parameter counted once."""
        params = list(params)
        sq = []
        for is_shard in (False, True):
            grads = [p.grad for p in params if (id(p) in sharded) == is_shard]
            s = (torch.sum(torch.stack(torch._foreach_norm(grads)) ** 2) if grads
                 else torch.zeros((), device=params[0].grad.device))
            sq.append(all_reduce_(s, self.group("model")) if is_shard else s)
        return torch.sqrt(sq[0] + sq[1])

    def reduce_metrics(self, metrics: Dict[str, Tensor], batch_sum: bool = False
                       ) -> Dict[str, Tensor]:
        """Scalar metrics of this rank's rows -> the global batch's: their
        mean over ``data`` (or their sum, for a batch-sum loss), in one
        collective."""
        n = self.size("data")
        if n == 1 or not metrics:
            return metrics
        keys = list(metrics)
        flat = all_reduce_(torch.stack([metrics[k].detach().float() for k in keys]),
                           self.group("data"))
        if not batch_sum:
            flat = flat / n
        return dict(zip(keys, flat.unbind()))


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axes: Tuple[str, ...] = ("data",)
              ) -> Mesh:
    """The mesh over every rank of the process group (one rank without
    one); ``shape`` defaults to all of them along ``axes[0]``."""
    if shape is None:
        shape = (dist.get_world_size() if dist.is_available() and dist.is_initialized()
                 else 1,)
    return Mesh(shape, axes)


def batch_sharding(mesh: Mesh, n: int, axis: str = "data", microbatches: int = 1) -> np.ndarray:
    """The rows of a global batch of ``n`` that this rank holds: its
    ``axis`` coordinate's share of each of the ``microbatches`` consecutive
    microbatches (JAX shards the microbatch axis, batch_dim=1), so each
    microbatch of the step is the one-process step's."""
    k = mesh.size(axis)
    if n % (microbatches * k):
        raise ValueError(f"batch of {n} does not split into {microbatches} microbatches "
                         f"over {k} ranks")
    micro, i = n // microbatches, mesh.index(axis)
    return np.concatenate([np.arange(j * micro + i * micro // k, j * micro + (i + 1) * micro // k)
                           for j in range(microbatches)])


def shard_batch(mesh: Mesh, batch: Dict[str, Any], axis: str = "data",
                microbatches: int = 1) -> Dict[str, Any]:
    """This rank's rows (``batch_sharding``) of every array of ``batch``
    (numpy arrays or tensors, batch first)."""
    n = len(next(iter(batch.values())))
    rows = batch_sharding(mesh, n, axis, microbatches)
    return {k: v[torch.from_numpy(rows).to(v.device)] if torch.is_tensor(v) else v[rows]
            for k, v in batch.items()}


def replicate(tree: Any, mesh: Mesh) -> Any:
    """In place: every tensor of ``tree`` (a module's parameters and buffers,
    or a sequence of tensors) set to that of the first rank that holds it
    (rank 0 for a replicated tensor; for a tensor-parallel shard, the first
    rank of its ``model`` index). Returns ``tree``."""
    if isinstance(tree, nn.Module):
        sharded = sharded_parameters(tree)
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        sharded, tensors = frozenset(), list(tree)
    with torch.no_grad():
        for t in tensors:
            axes = mesh.replica_axes(id(t) in sharded)
            group = mesh.group(*axes)
            if group is not None:
                broadcast_(t.data, mesh.origin(axes), group)
    return tree


def spatial_sharding(mesh: Mesh, space_axis: str = "space"):
    """The spatial sharding of a mesh: ``parallel/spatial.py::SpatialShard``
    over ``space_axis`` (dim 2 of NCHW / NCDHW), or None without one."""
    from causal_gen_tpu_torch.parallel.spatial import SpatialShard

    return SpatialShard(mesh, space_axis) if mesh.size(space_axis) > 1 else None


def shard_batch_spatial(mesh: Mesh, batch: Dict[str, Any], microbatches: int = 1,
                        batch_axis: str = "data", space_axis: str = "space") -> Dict[str, Any]:
    """This rank's part of a batch: every array's rows over ``batch_axis``,
    and an image's (x, NC(D)HW, ndim >= 4) dim 2 over ``space_axis`` where
    the plan shards its resolution (``SpatialShard.sharded``). Parent
    vectors are sharded over ``batch_axis`` only."""
    out = shard_batch(mesh, batch, batch_axis, microbatches)
    sp = spatial_sharding(mesh, space_axis)
    for k, v in out.items():
        if sp is not None and v.ndim >= 4 and sp.sharded(v.shape[2]):
            out[k] = sp.slab(v)
    return out


def param_partition_spec(name: str, leaf: Tensor, min_size_for_tp: int = 256
                         ) -> Tuple[Optional[str], ...]:
    """The tensor-parallel spec of parameter ``name``: ("model", None, ...)
    to shard dim 0 (a conv's or dense layer's out channels) over ``model``,
    () to replicate. The JAX rule (a flax ``kernel`` whose last dim is at
    least ``min_size_for_tp``) on torch names: a ``weight`` of 2 or more
    dims whose dim 0 is at least ``min_size_for_tp``."""
    if name.split(".")[-1] == "weight" and leaf.dim() >= 2 and leaf.shape[0] >= min_size_for_tp:
        return ("model",) + (None,) * (leaf.dim() - 1)
    return ()


def shard_params_tp(model: nn.Module, mesh: Mesh, min_size_for_tp: int = 256) -> nn.Module:
    """In place: ``model``'s parameters replicated from rank 0, then every
    Conv2d / Conv3d / Linear whose weight ``param_partition_spec`` picks and
    whose out channels split evenly over ``model`` made column-parallel; an
    uneven split stays replicated, as in JAX. Without a ``model`` axis, only
    the replication. Build the optimizer and the EMA after this."""
    replicate(model, mesh)
    n_model = mesh.size("model")
    if n_model == 1:
        return model
    for name, m in list(model.named_modules()):
        if type(m) in (nn.Conv2d, nn.Conv3d, nn.Linear):
            spec = param_partition_spec(f"{name}.weight", m.weight, min_size_for_tp)
            if spec and m.weight.shape[0] % n_model == 0:
                make_column_parallel(m, mesh)
    return model
