#!/usr/bin/env python
"""Top-op breakdown of a ``torch.profiler`` Chrome trace: the port's twin of
``tools/trace_ops.py``.

Reads every ``*.pt.trace.json`` under a directory (what
``causal_gen_tpu_torch/utils/profiling.py::trace`` writes) once, with no
``key_averages``, and prints the top-N ops by summed duration and a rollup by
the innermost enclosing ``record_function`` scope (``profiling.annotate``).

- A trace with device events (CUDA kernels, copies, memsets) is read on the
  device: each event's duration, attributed to the scopes open on the host
  when it was launched (the launch's runtime call shares the kernel's
  ``correlation`` id; without one, the device-side annotation spans that
  hold the kernel).
- A CPU-only trace has no kernel events: it is read as host ops, each op's
  self time (its duration less that of the ops nested in it), so nothing is
  counted twice.

Scopes are matched by time within a process, across its threads: the
autograd engine runs a CUDA backward on a thread of its own while the
caller's scope stays open.

Usage:
  python tools/mfu_torch.py --hps ukbb192 --bs 128 --trace_dir /tmp/tr
  python tools/trace_ops_torch.py /tmp/tr [--top 30]
"""

from __future__ import annotations

import argparse
import bisect
import collections
import glob
import json
import os
import sys
from typing import Dict, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TRACE_GLOB = "*.pt.trace.json"


class Op(NamedTuple):
    name: str
    us: float  # device duration, or a host op's self time
    scopes: Tuple[str, ...]  # enclosing record_function scopes, outermost first
    device: bool


def trace_files(trace_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(trace_dir, "**", TRACE_GLOB), recursive=True))


class _Spans:
    """Named [start, end] spans of one process or stream, sorted by start
    (outer before inner at equal starts), for 'which spans hold time t'."""

    def __init__(self, events):
        self.spans = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events),
                            key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float) -> Tuple[str, ...]:
        hi = bisect.bisect_right(self.starts, t)
        return tuple(name for start, end, name in self.spans[:hi] if end >= t)


def _self_times(ops) -> Dict[int, float]:
    """id(event) -> its duration less its directly nested ops', per thread."""
    out = {}
    by_thread = collections.defaultdict(list)
    for e in ops:
        by_thread[(e["pid"], e["tid"])].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []
        for e in evs:
            end = e["ts"] + e.get("dur", 0)
            while stack and stack[-1][1] + 1e-3 < end:  # 1 ns: the trace's resolution
                stack.pop()
            out[id(e)] = e.get("dur", 0)
            if stack:
                out[id(stack[-1][0])] -= e.get("dur", 0)
            stack.append((e, end))
    return out


def read_file(path: str) -> List[Op]:
    """The ops of one trace file, each with its scopes."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    by_cat = collections.defaultdict(list)
    for e in events:
        by_cat[e.get("cat")].append(e)
    scopes = collections.defaultdict(list)
    for e in by_cat["user_annotation"]:
        scopes[e["pid"]].append(e)
    scopes = {pid: _Spans(evs) for pid, evs in scopes.items()}

    def host_scopes(pid, t):
        return scopes[pid].at(t) if pid in scopes else ()

    device = [e for c in DEVICE_CATS for e in by_cat[c]]
    if device:
        launches = {e["args"]["correlation"]: e for c in LAUNCH_CATS for e in by_cat[c]
                    if "correlation" in e.get("args", {})}
        gpu_spans = collections.defaultdict(list)
        for e in by_cat["gpu_user_annotation"]:
            gpu_spans[(e["pid"], e["tid"])].append(e)
        gpu_spans = {k: _Spans(v) for k, v in gpu_spans.items()}
        ops = []
        for e in device:
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is not None:
                sc = host_scopes(launch["pid"], launch["ts"])
            else:
                spans = gpu_spans.get((e["pid"], e["tid"]))
                sc = spans.at(e["ts"]) if spans else ()
            ops.append(Op(e["name"], float(e.get("dur", 0)), sc, True))
        return ops
    cpu = by_cat["cpu_op"]
    self_us = _self_times(cpu)
    return [Op(e["name"], float(self_us[id(e)]), host_scopes(e["pid"], e["ts"]), False)
            for e in cpu]


def read_ops(trace_dir: str) -> List[Op]:
    """Every op of every trace under ``trace_dir``; device ops alone where
    any trace holds device events."""
    files = trace_files(trace_dir)
    if not files:
        raise FileNotFoundError(f"no {TRACE_GLOB} under {trace_dir}")
    ops = [op for p in files for op in read_file(p)]
    if any(op.device for op in ops):
        ops = [op for op in ops if op.device]
    return ops


def summarize(ops: List[Op]) -> Dict:
    """Totals by op name and by innermost scope ("(no scope)" outside any)."""
    by_op = collections.Counter()
    count = collections.Counter()
    by_scope = collections.Counter()
    for op in ops:
        by_op[op.name] += op.us
        count[op.name] += 1
        by_scope[op.scopes[-1] if op.scopes else "(no scope)"] += op.us
    return {"device": any(op.device for op in ops), "total_us": sum(by_op.values()),
            "by_op": [(n, us, count[n]) for n, us in by_op.most_common()],
            "by_scope": by_scope.most_common()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--min_pct", type=float, default=0.3)
    args = ap.parse_args()

    s = summarize(read_ops(args.trace_dir))
    total = s["total_us"]
    if total <= 0:
        sys.exit("no op events found")
    what = "device op time" if s["device"] else "host op self time (CPU trace: no device events)"
    print(f"total {what}: {total / 1e3:.3f} ms (all steps in the trace window)")
    print(f"\n{'%':>6}  {'ms':>9}  {'count':>6}  op")
    for shown, (name, us, n) in enumerate(s["by_op"]):
        pct = 100.0 * us / total
        if pct < args.min_pct or shown >= args.top:
            break
        print(f"{pct:6.2f}  {us / 1e3:9.3f}  {n:6d}  {name[:110]}")
    print("\nscope rollup (innermost record_function scope):")
    for scope, us in s["by_scope"]:
        print(f"{100.0 * us / total:6.2f}  {us / 1e3:9.3f}  {scope}")


if __name__ == "__main__":
    main()
