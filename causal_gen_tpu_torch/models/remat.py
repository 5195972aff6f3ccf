"""Rematerialisation with replayed draws.

``torch.utils.checkpoint`` drops a function's activations and recomputes them
in the backward. It restores only PyTorch's default generators, while the
port's draws come from an injected iterator (``noise``) or from a caller's
CPU ``torch.Generator`` (K1 and K4 seed Philox from it), so a plain
recompute would draw anew and give a gradient of another sample, with no
error. ``rematerialised`` replays both sources. ``pgm/dscm.py`` wraps each
HVAE pass of ``DSCM.forward(remat=True)`` in it, and ``models/hvae.py`` each
decoder block of a ``stage_scan`` run under ``cfg.remat`` (the unit of
``causal_gen_tpu/models/hvae.py::DecoderRunCell``, whose draw is inside).

The checkpoint is always the non-reentrant one: a reentrant checkpoint runs
the first forward with autograd off, where a light block would take K2
(``models/blocks.py::Block.takes_k2``) and the recompute its per-op convs,
so the gradient would belong to another function than the output.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint


def _recording(noise: Iterator[Tensor], taken: List[Tensor]) -> Iterator[Tensor]:
    for d in noise:
        taken.append(d)
        yield d


def rematerialised(fn: Callable, noise: Optional[Iterator[Tensor]],
                   generator: Optional[torch.Generator], *args):
    """``fn(*args, noise=, generator=)`` under ``torch.utils.checkpoint``
    (non-reentrant): its activations are dropped and recomputed in the
    backward. The recompute takes the same draws as the first run: the
    injected draws that run took from ``noise``, and ``generator`` set back
    to the state that run began with (then to where it was). Where autograd
    does not record, ``fn`` runs as it is: there is no backward to serve."""
    if not torch.is_grad_enabled():
        return fn(*args, noise=noise, generator=generator)
    start = None if generator is None else generator.get_state()
    taken: List[Tensor] = []
    runs = [0]

    def run(*a):
        runs[0] += 1
        if runs[0] == 1:
            return fn(*a, noise=None if noise is None else _recording(noise, taken),
                      generator=generator)
        now = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(start)
        try:
            return fn(*a, noise=None if noise is None else iter(taken), generator=generator)
        finally:
            if generator is not None:
                generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


def checkpointed(fn: Callable, *args):
    """``fn(*args)`` under the non-reentrant checkpoint where autograd
    records; for a function that draws nothing (a conv ``Block``)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)
