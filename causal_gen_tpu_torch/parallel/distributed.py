"""Multi-process start-up and per-rank data loading.

Counterpart of ``causal_gen_tpu/parallel/distributed.py``. Every process
calls ``initialize_multihost`` once, builds the same ``Mesh``
(``parallel/mesh.py``), computes the same global shuffle, loads only its own
rows of each global batch (``host_shard_indices``) and moves them to its
device (``make_global_batch``, the name kept so that a reader finds the
counterpart: in PyTorch a rank holds its shard, not a global array).

The backend is chosen, never switched: NCCL for a CUDA device, gloo for the
CPU (or the caller's ``backend``). A failed start raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device: "str | torch.device" = "cuda",
                         timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """``torch.distributed.init_process_group`` for this process; returns
    the device it runs on.

    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` default to torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. ``backend`` defaults to NCCL for a CUDA
    ``device`` and gloo for the CPU. A CUDA rank takes the card
    ``LOCAL_RANK`` (else its rank) modulo the cards it sees; NCCL refuses
    two ranks on one card, gloo takes them. ``timeout`` bounds every
    collective's wait (PyTorch's default when None)."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(env["RANK"]) if process_id is None else int(process_id)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost: a CUDA device was asked for and none "
                               "is available")
        if device.index is None:
            device = torch.device("cuda", int(env.get("LOCAL_RANK", rank))
                                  % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank,
                            **({} if timeout is None else {"timeout": timeout}))
    return device


def host_shard_indices(global_indices: np.ndarray, mesh=None) -> np.ndarray:
    """This rank's contiguous slice of a global batch-index array: its
    ``data`` coordinate's share under ``mesh``, else its rank's share of the
    process group (the whole array in one process)."""
    if mesh is not None:
        k, i = mesh.size("data"), mesh.index("data")
    elif dist.is_available() and dist.is_initialized():
        k, i = dist.get_world_size(), dist.get_rank()
    else:
        k, i = 1, 0
    per = len(global_indices) // k
    return global_indices[i * per:(i + 1) * per]


def make_global_batch(mesh, local_batch: Dict[str, np.ndarray],
                      device: "str | torch.device" = "cpu") -> Dict[str, Tensor]:
    """This rank's shard of a global batch (the rows ``host_shard_indices``
    gave it) as tensors on ``device``: an image ``x`` N(D)HWC -> NC(D)HW in
    its own dtype, every other array as it is. Each ``data`` rank must hold
    as many rows."""
    n = len(next(iter(local_batch.values())))
    if mesh.size("data") > 1:  # the largest and the smallest shard, on every rank
        span = torch.tensor([n, -n], device=device)
        dist.all_reduce(span, op=dist.ReduceOp.MAX, group=mesh.group("data"))
        if int(span[0]) != -int(span[1]):
            raise ValueError(f"the data ranks hold {-int(span[1])} to {int(span[0])} rows")
    out = {}
    for k, v in local_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if k == "x":
            t = t.permute(0, t.dim() - 1, *range(1, t.dim() - 1)).contiguous()
        out[k] = t
    return out
