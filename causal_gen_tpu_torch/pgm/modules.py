"""Neural nets used inside the PGMs (PyTorch, NCHW).

Counterpart of ``causal_gen_tpu/pgm/modules.py`` for what the Morpho-MNIST
and UK Biobank PGMs use: ``MLP`` and ``CNN`` (the anticausal predictors) and
``DenseNN`` (the context net of the conditional affine flows). Submodules
carry flax's auto-generated names (``Conv_0``, ``GroupNorm_0``, ``Dense_0``,
``LayerNorm_0``) so that converted parameters load key for key. Norms use
flax's epsilon, 1e-6, not PyTorch's default 1e-5.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

FLAX_NORM_EPS = 1e-6


def _gn(c: int) -> nn.GroupNorm:
    # reference norm_layer: GroupNorm(min(32, c//4), c) (flow_pgm.py:577)
    return nn.GroupNorm(max(1, min(32, c // 4)), c, eps=FLAX_NORM_EPS)


class MLP(nn.Module):
    """3-layer MLP head (reference layers.py:46-61, BatchNorm -> LayerNorm):
    (Dense without bias -> LayerNorm -> leaky_relu 0.01) twice, then Dense."""

    def __init__(self, in_dim: int, width: int = 32, num_outputs: int = 1):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, width, bias=False)
        self.LayerNorm_0 = nn.LayerNorm(width, eps=FLAX_NORM_EPS)
        self.Dense_1 = nn.Linear(width, width, bias=False)
        self.LayerNorm_1 = nn.LayerNorm(width, eps=FLAX_NORM_EPS)
        self.Dense_2 = nn.Linear(width, num_outputs)

    def forward(self, x: Tensor) -> Tensor:
        for dense, norm in ((self.Dense_0, self.LayerNorm_0), (self.Dense_1, self.LayerNorm_1)):
            x = F.leaky_relu(norm(dense(x)), 0.01)
        return self.Dense_2(x)


class CNN(nn.Module):
    """Small conv encoder (reference layers.py:64-104, BatchNorm -> GroupNorm):
    7x7 stem at stride 2 if res > 64, max-pool if res > 32, stride-2/1 3x3
    pairs doubling width, global mean pool, context concat, 2-layer head."""

    def __init__(self, input_res: int = 192, width: int = 16, num_outputs: int = 1,
                 context_dim: int = 0, input_channels: int = 1):
        super().__init__()
        w = width
        self.input_res = input_res
        s = 2 if input_res > 64 else 1
        specs = [(input_channels, w, 7, s, 3), (w, 2 * w, 3, 2, 1), (2 * w, 2 * w, 3, 1, 1),
                 (2 * w, 4 * w, 3, 2, 1), (4 * w, 4 * w, 3, 1, 1), (4 * w, 8 * w, 3, 2, 1)]
        self._layers = []
        for i, (cin, cout, k, stride, pad) in enumerate(specs):
            conv = nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)
            norm = _gn(cout)
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"GroupNorm_{i}", norm)
            self._layers.append((conv, norm))
        self.Dense_0 = nn.Linear(8 * w + context_dim, 8 * w, bias=False)
        self.LayerNorm_0 = nn.LayerNorm(8 * w, eps=FLAX_NORM_EPS)
        self.Dense_1 = nn.Linear(8 * w, num_outputs)

    def forward(self, x: Tensor, y: Optional[Tensor] = None) -> Tensor:
        for i, (conv, norm) in enumerate(self._layers):
            x = F.leaky_relu(norm(conv(x)), 0.01)
            if i == 0 and self.input_res > 32:
                x = F.max_pool2d(x, 2, 2)
        x = torch.mean(x, dim=(2, 3))  # global average pool
        if y is not None:
            x = torch.cat([x, y], dim=-1)
        x = F.leaky_relu(self.LayerNorm_0(self.Dense_0(x)), 0.01)
        return self.Dense_1(x)


class DenseNN(nn.Module):
    """Context net emitting one head per entry of ``param_dims``
    (pyro.nn.DenseNN, reference flow_pgm.py:148-157)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], param_dims: Sequence[int],
                 activation: str = "leaky_relu"):
        super().__init__()
        self.act = {
            "leaky_relu": lambda v: F.leaky_relu(v, 0.1),
            "gelu": lambda v: F.gelu(v, approximate="none"),
            "sigmoid": torch.sigmoid,
        }[activation]
        dims = [in_dim, *hidden]
        layers = [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])]
        layers += [nn.Linear(dims[-1], d) for d in param_dims]
        for i, layer in enumerate(layers):
            self.add_module(f"Dense_{i}", layer)
        self._hidden = layers[: len(hidden)]
        self._heads = layers[len(hidden):]

    def forward(self, x: Tensor) -> "Tensor | Tuple[Tensor, ...]":
        for layer in self._hidden:
            x = self.act(layer(x))
        outs = tuple(head(x) for head in self._heads)
        return outs if len(outs) > 1 else outs[0]
