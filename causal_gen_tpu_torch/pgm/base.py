"""SCM core: node specs and abduct/act/predict over a causal DAG (PyTorch).

Counterpart of ``causal_gen_tpu/pgm/base.py``: the node kinds
``BINARY_ROOT``, ``CATEGORICAL_ROOT``, ``FLOW`` (a normal or a Gumbel base;
the Gumbel base with ``SoftmaxCentered`` is the Gumbel-Softmax discrete
mechanism) and ``GUMBEL_MAX``; ancestral and reparameterised sampling,
abduction, the counterfactual with a do-dict (``counterfactual``) or with
per-row do-masks (``counterfactual_dense``), and the site log-probs
(``flow_logprob``, ``joint_logprob``). Values are {name: (B, d)} dicts.

Random draws come from a CPU ``torch.Generator`` (drawn on its device, then
moved: ``ops/distributions.py::draw``) or are injected: ``ancestral_sample``
takes each node's draw by name, ``sample_scm`` takes "<name>_base" entries,
and ``infer_exogeneous`` / ``counterfactual`` / ``counterfactual_dense`` take
``noise``, an iterator that yields the two standard-Gumbel draws (top, rest)
of each ``GUMBEL_MAX`` node's posterior in node order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from causal_gen_tpu_torch.ops.distributions import (
    bernoulli_logpmf_logits,
    onehot_categorical_logpmf,
    sample_bernoulli,
    sample_gumbel,
    sample_onehot_categorical,
)
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
    dim: int = 1  # event dim of the value (of the base draw, for a flow)
    base: str = "normal"  # FLOW base distribution: "normal" | "gumbel"
    out_dim: Optional[int] = None  # value dim where the transform changes dims


def _base_draw(node: Node, n: int, generator: Optional[torch.Generator], device) -> Tensor:
    """A flow node's base draw, (n, dim): standard normal or standard Gumbel."""
    if node.base == "gumbel":
        return sample_gumbel((n, node.dim), generator, device)
    return torch.randn((n, node.dim), generator=generator).to(device)


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
        noise = (sample_gumbel(k_obs.shape, generator, logits.device),
                 sample_gumbel(logits.shape, generator, logits.device))
    top, rest = noise
    m = top + torch.logsumexp(logits, dim=-1, keepdim=True)
    truncated = -torch.logaddexp(-m, -(rest + logits))
    mask = F.one_hot(k_obs[..., 0].long(), logits.shape[-1]).to(logits.dtype)
    return mask * m + (1.0 - mask) * truncated - logits


def _root_draw(node: Node, n: int, generator: Optional[torch.Generator], device,
               draw: Optional[Tensor] = None) -> Tensor:
    """A root's value for ``n`` rows from its ``draw`` (the uniform (n, 1) of
    a binary root, the standard Gumbel (n, K) of a categorical one), drawn
    from ``generator`` when None."""
    if node.kind == BINARY_ROOT:
        return sample_bernoulli(node.logits_fn(), (n, 1), generator, draw).to(device)
    return sample_onehot_categorical(node.logits_fn(), (n,), generator, draw).to(device)


def ancestral_sample(nodes: Sequence[Node], n: int, generator: Optional[torch.Generator] = None,
                     device: "str | torch.device" = "cpu",
                     noise: Optional[Dict[str, Tensor]] = None) -> Dict[str, Tensor]:
    """Forward sample of the DAG (causal_gen_tpu/pgm/base.py:73-98, reference
    BasePGM.sample). ``noise[name]`` is a node's draw: the uniform (n, 1) of a
    binary root, the standard Gumbel (n, K) of a categorical root or a
    Gumbel-Max node (argmax(g + logits), as ``jax.random.categorical``
    draws), the base draw (n, dim) of a flow; else it comes from
    ``generator`` and is moved to ``device``."""
    noise = noise or {}
    values: Dict[str, Tensor] = {}
    for node in nodes:
        d = noise.get(node.name)
        if node.kind in (BINARY_ROOT, CATEGORICAL_ROOT):
            values[node.name] = _root_draw(node, n, generator, device, d)
        else:
            exo = {} if d is None else {node.name + "_base": d}
            values[node.name] = _node_value(node, values, exo, n, generator, device)
    return values


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
            d = node.out_dim or node.dim
            if v.ndim == 0:
                v = v[None, None]
            elif v.ndim == 1:
                # (n,) batch of scalars when d == 1, else a single (d,) value
                v = v[:, None] if (d == 1 and v.shape[0] == n) else v[None, :]
            values[node.name] = torch.broadcast_to(v, (n, d))
        else:
            values[node.name] = _node_value(node, values, noise, n, generator, device)
    return values


def _node_value(node: Node, values: Dict[str, Tensor], exo: Dict[str, Tensor], n: int,
                generator: Optional[torch.Generator], device) -> Tensor:
    """A node's value given its parents' ``values`` and the exogenous
    ``exo``: a root's observed value (or a draw), a flow's transform of its
    "<name>_base" (or of a base draw), a Gumbel-Max argmax over its
    "<name>_base" (or a fresh Gumbel)."""
    if node.kind in (BINARY_ROOT, CATEGORICAL_ROOT):
        v = exo.get(node.name)
        return _root_draw(node, n, generator, device) if v is None else v
    if node.kind == FLOW:
        u = exo.get(node.name + "_base")
        if u is None:
            u = _base_draw(node, n, generator, device)
        return node.transform_fn(values).forward(u)[0]
    if node.kind == GUMBEL_MAX:
        logits = node.logits_fn(values)
        g = exo.get(node.name + "_base")
        if g is None:
            g = sample_gumbel(logits.shape, generator, logits.device)
        return _argmax_value(g, logits)
    raise ValueError(f"unknown node kind {node.kind}")


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


def counterfactual_dense(
    nodes: Sequence[Node],
    obs: Dict[str, Tensor],
    do_values: Dict[str, Tensor],
    do_mask: Dict[str, Tensor],
    num_particles: int = 1,
    generator: Optional[torch.Generator] = None,
    discrete_variables: Optional[Dict[str, str]] = None,
    noise: Optional[Iterator[Tensor]] = None,
) -> Dict[str, Tensor]:
    """The counterfactual under per-row interventions
    (causal_gen_tpu/pgm/base.py:243-320): ``do_values[name]`` (B, d) and
    ``do_mask[name]`` (B, 1) of 0/1, so that each row takes its own pattern in
    one pass. Abduction as in ``counterfactual`` (its Gumbel-Max draws from
    ``noise`` in the same order); every node without a "<name>_base" keeps
    its observed value as its exogenous input; each node's value is then
    replaced by its do value where the row's mask is > 0, before its children
    read it. With ``discrete_variables`` holding ``finding`` (MIMIC), a row
    keeps its observed finding unless its mask sets age or finding."""
    first = next(iter(obs.values()))
    n = first.shape[0]
    names = [nd.name for nd in nodes]
    avg = {k: torch.zeros_like(obs[k]) for k in names}
    for _ in range(num_particles):
        exo = {k: v.detach()
               for k, v in infer_exogeneous(nodes, obs, generator, noise).items()}
        for nd in nodes:
            if (nd.name + "_base") not in exo:
                exo[nd.name] = obs[nd.name]
        values: Dict[str, Tensor] = {}
        for nd in nodes:
            v = _node_value(nd, values, exo, n, generator, first.device)
            if nd.name in do_values:
                v = torch.where(do_mask[nd.name] > 0, do_values[nd.name], v)
            values[nd.name] = v
        if discrete_variables is not None and "finding" in discrete_variables:
            zero = torch.zeros((n, 1), device=first.device)
            restore = ((1.0 - do_mask.get("age", zero)) * (1.0 - do_mask.get("finding", zero)))
            values["finding"] = torch.where(restore > 0, obs["finding"], values["finding"])
        for k in names:
            avg[k] = avg[k] + values[k] / num_particles
    return avg


_LOG_SQRT_2PI = 0.9189385332046727


def flow_logprob(t: Transform, y: Tensor, base: str = "normal") -> Tensor:
    """log p(y) under TransformedDistribution(base, t)
    (causal_gen_tpu/pgm/base.py:323-334): the base log-density at
    u = t^-1(y) plus the inverse logdet, summed over the event; a per-event
    logdet (``SoftmaxCentered``) is added after the sum."""
    u, inv_ld = t.inverse(y)
    if base == "gumbel":
        base_lp = -(u + torch.exp(-u))
    else:
        base_lp = -0.5 * (u**2) - _LOG_SQRT_2PI
    if inv_ld.dim() == base_lp.dim():
        return torch.sum(base_lp + inv_ld, dim=-1)
    return torch.sum(base_lp, dim=-1) + inv_ld


def joint_logprob(nodes: Sequence[Node], obs: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Per-site log p(obs), every site observed (causal_gen_tpu/pgm/base.py:
    337-363; reference svi_model under Trace_ELBO with an empty guide). A
    Gumbel-Max site takes the categorical marginal of its argmax,
    log_softmax(logits) at the observed class."""
    out: Dict[str, Tensor] = {}
    for node in nodes:
        y = obs[node.name]
        if node.kind == BINARY_ROOT:
            out[node.name] = torch.sum(bernoulli_logpmf_logits(y, node.logits_fn()), dim=-1)
        elif node.kind == CATEGORICAL_ROOT:
            out[node.name] = onehot_categorical_logpmf(y, node.logits_fn())
        elif node.kind == FLOW:
            out[node.name] = flow_logprob(node.transform_fn(obs), y, node.base)
        elif node.kind == GUMBEL_MAX:
            lp = F.log_softmax(node.logits_fn(obs), dim=-1)
            out[node.name] = torch.gather(lp, -1, y.long())[..., 0]
        else:
            raise ValueError(f"unknown node kind {node.kind}")
    return out
