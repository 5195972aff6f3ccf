"""Profiling and tracing hooks.

Counterpart of ``causal_gen_tpu/utils/profiling.py``: ``torch.profiler`` in
place of JAX's profiler. ``trace`` writes a Chrome trace (the JSON that
Perfetto and ``chrome://tracing`` open) into a directory, which
``tools/trace_ops_torch.py`` reads; ``annotate`` names a region in it; the
step timer gives steady-state step times and throughput.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Any, Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace of the enclosed block into ``log_dir``
    (host ops, and device kernels and copies where CUDA is available):
    with profiling.trace('/tmp/trace'): run_steps(...)"""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}{TRACE_SUFFIX}"
    prof.export_chrome_trace(os.path.join(log_dir, name))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the profiler timeline."""
    with record_function(name):
        yield


def synchronize(result: Any) -> None:
    """Wait for the CUDA devices that hold the tensors of ``result`` (a
    tensor, or a dict, list or tuple of them): ``jax.block_until_ready``."""
    devices = set()

    def visit(r):
        if isinstance(r, torch.Tensor):
            if r.is_cuda:
                devices.add(r.device)
        elif isinstance(r, dict):
            for v in r.values():
                visit(v)
        elif isinstance(r, (list, tuple)):
            for v in r:
                visit(v)

    visit(result)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Wall-clock step timing with the first (warm-up) steps left out."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            synchronize(result)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.skip_first:
            self.times.append(dt)
        return dt

    @property
    def mean_ms(self) -> float:
        return 1000.0 * sum(self.times) / max(len(self.times), 1)

    def throughput(self, items_per_step: int) -> float:
        if not self.times:
            return 0.0
        return items_per_step * len(self.times) / sum(self.times)
