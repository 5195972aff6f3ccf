"""SCM core: node specs and abduct/act/predict over a causal DAG (PyTorch).

Counterpart of ``causal_gen_tpu/pgm/base.py`` for the node kinds the
Morpho-MNIST, UK Biobank and MIMIC PGMs reach: ``BINARY_ROOT``,
``CATEGORICAL_ROOT``, ``FLOW`` (normal base) and ``GUMBEL_MAX``. Values are
{name: (B, d)} dicts.

Random draws come from a CPU ``torch.Generator`` (drawn on its device, then
moved: ``ops/distributions.py::draw``) or are injected: ``sample_scm`` takes
"<name>_base" entries, and ``infer_exogeneous`` / ``counterfactual`` take
``noise``, an iterator that yields the two standard-Gumbel draws (top, rest)
of each ``GUMBEL_MAX`` node's posterior in node order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from causal_gen_tpu_torch.ops.distributions import draw, sample_bernoulli
from causal_gen_tpu_torch.pgm.transforms import Transform

BINARY_ROOT = "binary_root"  # Bernoulli(logits), value (B, 1) of 0.0 / 1.0
CATEGORICAL_ROOT = "categorical_root"  # OneHotCategorical(logits), value (B, K)
FLOW = "flow"  # TransformedDistribution(N(0,1), transform(parents))
GUMBEL_MAX = "gumbel_max"  # argmax(Gumbel + logits(parents)), value (B, 1) class index


@dataclass
class Node:
    name: str
    kind: str
    parents: Tuple[str, ...] = ()
    # binary/categorical root: () -> (1, K); gumbel_max: (values) -> (B, K)
    logits_fn: Optional[Callable[..., Tensor]] = None
    transform_fn: Optional[Callable[[Dict[str, Tensor]], Transform]] = None  # flow
    dim: int = 1  # event dim of the value


def standard_gumbel(shape, generator: Optional[torch.Generator], device) -> Tensor:
    """-log(-log u), u uniform on [tiny, 1), as ``jax.random.gumbel`` draws."""
    u = draw(torch.rand, shape, generator, device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def _argmax_value(g: Tensor, logits: Tensor) -> Tensor:
    return torch.argmax(g + logits, dim=-1, keepdim=True).to(torch.float32)


def gumbel_posterior(logits: Tensor, k_obs: Tensor, generator: Optional[torch.Generator] = None,
                     noise: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """Exact posterior draw of the standard-Gumbel noise g given
    argmax_j(g_j + logits_j) == k (causal_gen_tpu/pgm/base.py:160-184): the
    max M ~ Gumbel(logsumexp(logits)) goes to class k, every other class is a
    location-Gumbel capped below M by -logaddexp(-M, -g_loc), and the logits
    come off again. ``noise=(top, rest)`` are the two standard-Gumbel draws,
    (B, 1) and (B, K); else they are drawn from ``generator``.

    ``logits`` (B, K), ``k_obs`` (B, 1) class index; returns (B, K) g."""
    if noise is None:
        noise = (standard_gumbel(k_obs.shape, generator, logits.device),
                 standard_gumbel(logits.shape, generator, logits.device))
    top, rest = noise
    m = top + torch.logsumexp(logits, dim=-1, keepdim=True)
    truncated = -torch.logaddexp(-m, -(rest + logits))
    mask = F.one_hot(k_obs[..., 0].long(), logits.shape[-1]).to(logits.dtype)
    return mask * m + (1.0 - mask) * truncated - logits


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

    ``noise`` entries: "<name>_base" for flow and Gumbel-Max sites, or the
    plain "<name>" observed value for root sites. ``do`` wins over everything and cuts the
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
        elif node.kind == GUMBEL_MAX:
            logits = node.logits_fn(values)
            g = noise.get(node.name + "_base")
            if g is None:
                g = standard_gumbel(logits.shape, generator, logits.device)
            values[node.name] = _argmax_value(g, logits)
        else:
            raise ValueError(f"unknown node kind {node.kind}")
    return values


def infer_exogeneous(nodes: Sequence[Node], obs: Dict[str, Tensor],
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Iterator[Tensor]] = None) -> Dict[str, Tensor]:
    """Abduction of the exogenous noise (reference flow_pgm.py:47-65): exact
    inversion at flow sites, a posterior draw at Gumbel-Max sites (its two
    draws from ``noise`` when given, else from ``generator``); root sites
    have none."""
    out: Dict[str, Tensor] = {}
    for node in nodes:
        if node.kind == FLOW:
            out[node.name + "_base"], _ = node.transform_fn(obs).inverse(obs[node.name])
        elif node.kind == GUMBEL_MAX:
            draws = None if noise is None else (next(noise), next(noise))
            out[node.name + "_base"] = gumbel_posterior(node.logits_fn(obs), obs[node.name],
                                                        generator, draws)
        elif node.kind not in (BINARY_ROOT, CATEGORICAL_ROOT):
            raise ValueError(f"unknown node kind {node.kind}")
    return out


def counterfactual(
    nodes: Sequence[Node],
    obs: Dict[str, Tensor],
    intervention: Dict[str, Tensor],
    num_particles: int = 1,
    generator: Optional[torch.Generator] = None,
    discrete_variables: Optional[Dict[str, str]] = None,
    noise: Optional[Iterator[Tensor]] = None,
) -> Dict[str, Tensor]:
    """Abduct -> act -> predict, averaged over particles in value space
    (reference flow_pgm.py:67-108). Flow abduction is exact; a Gumbel-Max
    site's posterior is drawn anew for each particle.

    With ``discrete_variables`` holding ``finding`` (the MIMIC PGM), the
    observed finding is kept when neither it nor its parent age is
    intervened on (causal_gen_tpu/pgm/base.py:228-237)."""
    first = next(iter(obs.values()))
    n = first.shape[0]
    names = [nd.name for nd in nodes]
    avg = {k: torch.zeros_like(obs[k]) for k in names}
    for _ in range(num_particles):
        exo = {k: v.detach()
               for k, v in infer_exogeneous(nodes, obs, generator, noise).items()}
        # root nodes without flows keep their observed values (flow_pgm.py:85-88)
        for nd in nodes:
            if nd.name not in intervention and (nd.name + "_base") not in exo:
                exo[nd.name] = obs[nd.name]
        cfs = sample_scm(nodes, n, noise=exo, do=intervention, generator=generator,
                         device=first.device)
        if discrete_variables is not None and "finding" in discrete_variables \
                and "age" not in intervention and "finding" not in intervention:
            cfs["finding"] = obs["finding"]
        for k in names:
            avg[k] = avg[k] + cfs[k] / num_particles
    return avg
