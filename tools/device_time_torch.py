#!/usr/bin/env python
"""Device time of a callable from the profiler's trace: the port's twin of
``tools/device_time.py``.

A host clock around a few calls measures the enqueue as much as the work:
CUDA launches return before the device runs them, and a synchronise after a
window adds the wait for the host's own readback. The device's own record is
the profiler's kernel events. The care taken here:
- Each call of the measured callable runs inside a named ``record_function``
  scope (``profiling.annotate``), and only the device events launched inside
  that scope are summed. The sync after the window, and its copy, fall
  outside it.
- Only kernels, copies and memsets are summed, never the trace's annotation
  spans: a device-side annotation covers the kernels inside it, so adding
  both would count them twice.
- The trace is read once (``tools/trace_ops_torch.py``), not through
  ``key_averages``.
Device durations do not include host stalls, so two windows suffice; a
window with no event in the scope is discarded, and a run with none in any
window raises. A CPU run has no device events and raises too: it has no
device time.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from causal_gen_tpu_torch.utils import profiling  # noqa: E402
from tools.trace_ops_torch import read_ops  # noqa: E402


def scope_ms(trace_dir: str, scope: str) -> float:
    """Device ms of the kernels, copies and memsets launched inside every
    ``scope`` of the traces under ``trace_dir`` (at any depth inside it)."""
    ops = read_ops(trace_dir)
    if not any(op.device for op in ops):
        raise RuntimeError(f"no device events in the trace under {trace_dir}: a CPU run has "
                           "no device time")
    return sum(op.us for op in ops if scope in op.scopes) / 1e3


def device_ms_per_iter(dispatch, iters: int = 10, windows: int = 2, scope: str = "",
                       tag: str = "op") -> float:
    """Device ms per iteration of ``dispatch(i) -> output``, best of windows.

    Each ``dispatch(i)`` runs inside ``profiling.annotate(scope)``; ``scope``
    must name no other region the callable opens (the sum takes every event
    under a scope of that name)."""
    if not scope:
        raise ValueError("scope is required (see the module docstring)")
    profiling.synchronize(dispatch(0))
    best = float("inf")
    for w in range(windows):
        tdir = tempfile.mkdtemp(prefix=f"devtime_{tag}_")
        try:
            with profiling.trace(tdir):
                for i in range(iters):
                    with profiling.annotate(scope):
                        y = dispatch(1 + w * iters + i)
                profiling.synchronize(y)
            ms = scope_ms(tdir, scope) / iters
            if ms > 0:
                best = min(best, ms)
        finally:
            shutil.rmtree(tdir, ignore_errors=True)
    if best == float("inf"):
        raise RuntimeError(f"no device events in scope {scope!r} in any window")
    return best
