"""Start ``n`` ranks on this machine, one process each, and collect what each
returns.

``spawn(fn, n)`` runs ``fn(rank, n, device, *args)`` in ``n`` fresh
processes (the ``spawn`` start method) joined by ``torch.distributed`` over
``tcp://localhost:<a free port>``: gloo on the CPU by default, or the
backend and device the caller names (gloo ranks may share one card; NCCL
refuses that). Each rank runs ``torch.set_num_threads(1)``, since the
ranks share the machine's cores. A rank
that raises, dies or outlives ``timeout`` seconds ends every rank and raises
here, with the rank's traceback: nothing hangs and no rank carries on
alone. ``fn`` and its results cross processes by pickling, so ``fn`` is a
module-level function and returns numpy arrays or plain values.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def free_port() -> int:
    """A TCP port on localhost that no process listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(call_path, rank, world, port, device, backend, timeout, out):
    import torch
    import torch.distributed as dist

    from causal_gen_tpu_torch.parallel.distributed import initialize_multihost

    torch.set_num_threads(1)
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)  # written by ``spawn`` in this run
        dev = initialize_multihost(f"localhost:{port}", world, rank, backend, device,
                                   timeout=datetime.timedelta(seconds=timeout))
        out.put((rank, True, fn(rank, world, dev, *args)))
    except BaseException:  # reported to the parent, which ends every rank
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), device: str = "cpu",
          backend: Optional[str] = None, timeout: float = 120.0) -> List[Any]:
    """``fn(rank, world, device, *args)`` on ``world`` ranks; returns their
    results in rank order (module docstring). A start that loses its port to
    another process (between ``free_port`` and rank 0's bind) starts again
    on another, twice at most."""
    for _ in range(2):
        try:
            return _spawn_once(fn, world, args, device, backend, timeout)
        except RuntimeError as e:
            if "EADDRINUSE" not in str(e):
                raise
    return _spawn_once(fn, world, args, device, backend, timeout)


def _spawn_once(fn, world, args, device, backend, timeout) -> List[Any]:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    # fn and args reach the ranks through a file: multiprocessing writes a
    # process's start-up payload to a pipe whose read end the parent holds
    # until the write ends, so a large payload to a child that dies before
    # reading it would block the parent for good
    with tempfile.NamedTemporaryFile(prefix="spawn_", suffix=".pkl", delete=False) as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(f.name, r, world, port, device, backend, timeout, out))
             for r in range(world)]
    results, deadline = {}, time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results
                        and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode}) without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} "
                                       f"still running after {timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            p.join(timeout=5.0 if len(results) == world else 0.0)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        os.unlink(f.name)
    return [results[r] for r in range(world)]
