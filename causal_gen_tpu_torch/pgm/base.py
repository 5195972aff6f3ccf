"""SCM core: node specs and abduct/act/predict over a causal DAG (PyTorch).

Counterpart of ``causal_gen_tpu/pgm/base.py`` for the node kinds the
Morpho-MNIST and UK Biobank PGMs reach: ``BINARY_ROOT``, ``CATEGORICAL_ROOT``
and ``FLOW`` (normal base). Values are {name: (B, d)} dicts. The Gumbel-Max
posterior comes with the MIMIC slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from causal_gen_tpu_torch.ops.distributions import sample_bernoulli
from causal_gen_tpu_torch.pgm.transforms import Transform

BINARY_ROOT = "binary_root"  # Bernoulli(logits), value (B, 1) of 0.0 / 1.0
CATEGORICAL_ROOT = "categorical_root"  # OneHotCategorical(logits), value (B, K)
FLOW = "flow"  # TransformedDistribution(N(0,1), transform(parents))


@dataclass
class Node:
    name: str
    kind: str
    parents: Tuple[str, ...] = ()
    logits_fn: Optional[Callable[[], Tensor]] = None  # binary/categorical root: () -> (1, K)
    transform_fn: Optional[Callable[[Dict[str, Tensor]], Transform]] = None  # flow
    dim: int = 1  # event dim of the value


def _onehot_sample(logits: Tensor, n: int, generator: Optional[torch.Generator]) -> Tensor:
    probs = torch.softmax(logits.detach().cpu(), dim=-1).expand(n, -1)
    idx = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return F.one_hot(idx, logits.shape[-1]).to(torch.float32).to(logits.device)


def sample_scm(
    nodes: Sequence[Node],
    n: int,
    noise: Optional[Dict[str, Tensor]] = None,
    do: Optional[Dict[str, Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    device: "str | torch.device" = "cpu",
) -> Dict[str, Tensor]:
    """Reparameterized SCM forward pass with optional exogenous conditioning
    and interventions (reference flow_pgm.py:28-40, 90-94).

    ``noise`` entries: "<name>_base" for flow sites, or the plain "<name>"
    observed value for root sites. ``do`` wins over everything and cuts the
    node from its parents. Draws come from ``generator`` (a CPU generator)
    and are moved to ``device``.
    """
    noise = noise or {}
    do = do or {}
    values: Dict[str, Tensor] = {}
    for node in nodes:
        if node.name in do:
            v = torch.as_tensor(do[node.name], dtype=torch.float32, device=device)
            d = node.dim
            if v.ndim == 0:
                v = v[None, None]
            elif v.ndim == 1:
                # (n,) batch of scalars when d == 1, else a single (d,) value
                v = v[:, None] if (d == 1 and v.shape[0] == n) else v[None, :]
            values[node.name] = torch.broadcast_to(v, (n, d))
        elif node.kind in (BINARY_ROOT, CATEGORICAL_ROOT):
            if node.name in noise:  # observed root passthrough
                values[node.name] = noise[node.name]
            elif node.kind == BINARY_ROOT:
                logits = node.logits_fn()
                values[node.name] = sample_bernoulli(logits, (n, 1), generator).to(device)
            else:
                values[node.name] = _onehot_sample(node.logits_fn(), n, generator)
        elif node.kind == FLOW:
            u = noise.get(node.name + "_base")
            if u is None:
                u = torch.randn((n, node.dim), generator=generator).to(device)
            values[node.name], _ = node.transform_fn(values).forward(u)
        else:
            raise NotImplementedError(f"node kind {node.kind} is not ported yet")
    return values


def infer_exogeneous(nodes: Sequence[Node], obs: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Abduction of the exogenous noise at flow sites by exact inversion
    (reference flow_pgm.py:47-65); root sites have none."""
    out: Dict[str, Tensor] = {}
    for node in nodes:
        if node.kind == FLOW:
            out[node.name + "_base"], _ = node.transform_fn(obs).inverse(obs[node.name])
        elif node.kind not in (BINARY_ROOT, CATEGORICAL_ROOT):
            raise NotImplementedError(f"node kind {node.kind} is not ported yet")
    return out


def counterfactual(
    nodes: Sequence[Node],
    obs: Dict[str, Tensor],
    intervention: Dict[str, Tensor],
    num_particles: int = 1,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Tensor]:
    """Abduct -> act -> predict, averaged over particles in value space
    (reference flow_pgm.py:67-108). Flow abduction is exact, so with only
    flow and observed root sites every particle is the same."""
    first = next(iter(obs.values()))
    n = first.shape[0]
    names = [nd.name for nd in nodes]
    avg = {k: torch.zeros_like(obs[k]) for k in names}
    for _ in range(num_particles):
        noise = {k: v.detach() for k, v in infer_exogeneous(nodes, obs).items()}
        # root nodes without flows keep their observed values (flow_pgm.py:85-88)
        for nd in nodes:
            if nd.name not in intervention and (nd.name + "_base") not in noise:
                noise[nd.name] = obs[nd.name]
        cfs = sample_scm(nodes, n, noise=noise, do=intervention, generator=generator,
                         device=first.device)
        for k in names:
            avg[k] = avg[k] + cfs[k] / num_particles
    return avg
