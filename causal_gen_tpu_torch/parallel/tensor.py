"""Tensor parallelism: column-parallel conv and dense layers over the mesh's
``model`` axis, and checkpoints that gather their shards.

JAX shards a wide kernel's output-channel dim over ``model`` and lets GSPMD
insert the collectives (``causal_gen_tpu/parallel/mesh.py:96-116``). Here a
layer that the rule picks (``mesh.param_partition_spec``) keeps its shard of
the out channels (rows ``[m n, (m + 1) n)`` of its torch ``weight``, m its
``model`` index), computes them, and all-gathers the output over channels
(``collectives.all_gather``, whose backward sums the cotangents and hands each
rank its shard's). Its bias stays whole, replicated as JAX leaves it (a
``bias`` is not a ``kernel``), and each rank adds its slice. The layer's
class is swapped in place for its column-parallel subclass, so its name and
its ``state_dict`` keys stay; AdamW and the EMA then hold the shards.

PyTorch's DTensor conv rule does not shard a conv's weight, so nothing here
rests on it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from causal_gen_tpu_torch.parallel.collectives import all_gather, gather_parts


class ColumnParallel:
    """Mixin of the column-parallel layers: this rank's out channels, then
    an all-gather of the output over the ``model`` axis."""

    tp_mesh: Any
    tp_out: int  # the layer's whole out channels

    def _tp_setup(self, mesh) -> None:
        n_model, m = mesh.size("model"), mesh.index("model")
        self.tp_mesh = mesh
        self.tp_out = self.weight.shape[0]
        n = self.tp_out // n_model
        with torch.no_grad():
            self.weight = nn.Parameter(self.weight[m * n:(m + 1) * n].clone())

    def tp_slice(self, t: Tensor) -> Tensor:
        """This rank's rows of a tensor of the whole layer's out channels."""
        n = self.weight.shape[0]
        return t.narrow(0, self.tp_mesh.index("model") * n, n)

    def tp_gather(self, y: Tensor, dim: int) -> Tensor:
        return all_gather(y, dim, self.tp_mesh.group("model"))


def conv_padded(conv: nn.Module, x: Tensor, weight: Tensor, bias: Optional[Tensor],
                padding) -> Tensor:
    """``conv``'s convolution of ``x`` with ``weight`` and ``bias`` at
    ``padding`` (its own stride, dilation and groups); a column-parallel conv
    adds its slice of the bias and gathers its output over channels."""
    tp = isinstance(conv, ColumnParallel)
    if tp and bias is not None:
        bias = conv.tp_slice(bias)
    fn = F.conv2d if weight.dim() == 4 else F.conv3d
    y = fn(x, weight, bias, conv.stride, padding, conv.dilation, conv.groups)
    return conv.tp_gather(y, 1) if tp else y


class ColumnParallelConv2d(ColumnParallel, nn.Conv2d):
    def _conv_forward(self, input, weight, bias):
        return conv_padded(self, input, weight, bias, self.padding)


class ColumnParallelConv3d(ColumnParallel, nn.Conv3d):
    def _conv_forward(self, input, weight, bias):
        return conv_padded(self, input, weight, bias, self.padding)


class ColumnParallelLinear(ColumnParallel, nn.Linear):
    def forward(self, x):
        bias = None if self.bias is None else self.tp_slice(self.bias)
        return self.tp_gather(F.linear(x, self.weight, bias), -1)


PARALLEL_CLASS = {nn.Conv2d: ColumnParallelConv2d, nn.Conv3d: ColumnParallelConv3d,
                  nn.Linear: ColumnParallelLinear}


def make_column_parallel(layer: nn.Module, mesh) -> None:
    """In place: ``layer`` (a Conv2d, Conv3d or Linear) keeps this rank's
    shard of its out channels and runs column-parallel."""
    layer.__class__ = PARALLEL_CLASS[type(layer)]
    layer._tp_setup(mesh)


def full_weight(layer: nn.Module) -> Tensor:
    """The whole weight of ``layer``: a column-parallel layer's shards
    gathered (not differentiable), any other layer's own."""
    if not isinstance(layer, ColumnParallel):
        return layer.weight
    return torch.cat(gather_parts(layer.weight.detach(), layer.tp_mesh.group("model")), 0)


def sharded_layers(module: nn.Module) -> Dict[str, ColumnParallel]:
    """The column-parallel layers of ``module`` by name."""
    return {name: m for name, m in module.named_modules() if isinstance(m, ColumnParallel)}


def sharded_parameters(module: nn.Module) -> set:
    """The ids of ``module``'s sharded parameters (column-parallel weights)."""
    return {id(m.weight) for m in sharded_layers(module).values()}


def gather_state(module: nn.Module) -> Dict[str, Tensor]:
    """``module.state_dict()`` with every sharded weight gathered whole, on
    the CPU. Every rank calls it (it all-gathers)."""
    sd = {k: v.detach() for k, v in module.state_dict().items()}
    for name, layer in sharded_layers(module).items():
        sd[f"{name}.weight" if name else "weight"] = full_weight(layer)
    return {k: v.cpu() for k, v in sd.items()}


def shard_state(module: nn.Module, full: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """A whole ``state_dict`` cut to ``module``'s shards."""
    out = dict(full)
    for name, layer in sharded_layers(module).items():
        key = f"{name}.weight" if name else "weight"
        out[key] = layer.tp_slice(full[key])
    return out


def _param_layers(module: nn.Module, params: Iterable[Tensor]):
    """For each parameter, in order, its column-parallel layer or None."""
    owner = {id(m.weight): m for m in sharded_layers(module).values()}
    return [owner.get(id(p)) for p in params]


def gather_optimizer_state(optimizer: torch.optim.Optimizer, module: nn.Module
                           ) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with the moments of ``module``'s sharded
    weights gathered whole (the optimizer holds ``module``'s parameters in
    ``module.parameters()`` order). Every rank calls it."""
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, layer in enumerate(_param_layers(module, params)):
        s = dict(sd["state"].get(i, {}))
        if layer is not None:
            group = layer.tp_mesh.group("model")
            for k, v in s.items():
                if torch.is_tensor(v) and v.shape == layer.weight.shape:
                    s[k] = torch.cat(gather_parts(v, group), 0)
        if s:
            state[i] = s
    return {"state": state, "param_groups": sd["param_groups"]}


def shard_optimizer_state(optimizer: torch.optim.Optimizer, module: nn.Module,
                          full: Dict[str, Any]) -> Dict[str, Any]:
    """A whole optimizer ``state_dict`` cut to the shards ``optimizer`` holds."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, layer in enumerate(_param_layers(module, params)):
        s = dict(full["state"].get(i, {}))
        if layer is not None:
            s = {k: layer.tp_slice(v) if torch.is_tensor(v) and v.dim() > 0
                 and v.shape[0] == layer.tp_out else v for k, v in s.items()}
        if s:
            state[i] = s
    return {"state": state, "param_groups": full["param_groups"]}
