#!/usr/bin/env python
"""Multi-process data-parallel HVAE training with the PyTorch port.

Twin of ``examples/multihost_train.py``: one process per device (one rank),
the same ``data`` mesh on every rank, the same global shuffle on every rank,
each rank loading only its contiguous share of each global batch and taking
the parallel train step (``train/vae_trainer.py::train_step(mesh=)``), whose
update is the one-process update at the same global batch.

Launch the same command on every rank, with torchrun:

  torchrun --nproc_per_node 8 examples/multihost_train_torch.py --hps morphomnist \\
      --data_dir DIR --epochs 10 --global_bs 1024

or with explicit flags, one process each:

  python examples/multihost_train_torch.py --coordinator host:port --num_processes N \\
      --process_id i ...

NCCL and one card a rank by default; ``--device cpu`` runs gloo on the CPU.
``--smoke`` takes a tiny HVAE and two steps on a synthetic batch (a CPU
check; one process alone runs it too).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--hps", default="morphomnist")
    p.add_argument("--data_dir", default="")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--global_bs", type=int, default=256)
    p.add_argument("--coordinator", default=None, help="host:port of rank 0")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    p.add_argument("--backend", default=None, help="override the device's backend")
    p.add_argument("--smoke", action="store_true",
                   help="tiny arch + 2 steps on a synthetic batch (CPU check)")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from causal_gen_tpu_torch import resolve_device
    from causal_gen_tpu_torch.config import get_config
    from causal_gen_tpu_torch.data.datasets import setup_datasets
    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.parallel import (
        host_shard_indices,
        initialize_multihost,
        make_global_batch,
        make_mesh,
        replicate,
    )
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import train_step

    # 1. one process group per run: explicit flags, else torchrun's environment
    if args.coordinator or args.num_processes or "WORLD_SIZE" in os.environ:
        device = initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                      args.backend, args.device)
    else:
        device = resolve_device(args.device)

    overrides = dict(bs=args.global_bs, data_dir=args.data_dir)
    if args.smoke:
        overrides.update(
            input_res=16, enc_arch="16b1d2,8b1d2,4b1d4,1b1",
            dec_arch="1b1,4b1,8b1,16b1", widths=(8, 8, 16, 16), z_dim=4,
            bias_max_res=16, epochs=1,
        )
    cfg = get_config(args.hps, **overrides)

    # 2. the same mesh on every rank: every process along `data`
    mesh = make_mesh(axes=("data",))
    if mesh.rank == 0:
        print(f"processes={mesh.world} backend="
              f"{dist.get_backend() if dist.is_initialized() else 'none'} device={device} "
              f"mesh={mesh.shape}", flush=True)

    model = replicate(HVAE(cfg, device=device,
                           generator=torch.Generator().manual_seed(cfg.seed)), mesh)
    state = init_train_state(cfg, model)
    datasets = None if args.smoke else setup_datasets(cfg)

    steps = 2 if args.smoke else None
    n = len(datasets["train"]) if datasets else args.global_bs * 2
    order = np.arange(n)
    it = 0
    for epoch in range(1, (1 if args.smoke else args.epochs) + 1):
        # every rank computes the SAME global shuffle, then loads only its own
        # contiguous share of each global batch
        np.random.default_rng(cfg.seed + epoch).shuffle(order)
        t0 = time.time()
        for s in range(n // args.global_bs):
            global_idx = order[s * args.global_bs:(s + 1) * args.global_bs]
            local_idx = host_shard_indices(global_idx, mesh)
            if datasets is not None:
                local = datasets["train"].batch(local_idx, np.random.default_rng(cfg.seed + it))
            else:  # smoke: a synthetic local share
                k = len(local_idx)
                local = {"x": np.zeros((k, cfg.input_res, cfg.input_res, cfg.input_channels),
                                       np.uint8),
                         "pa": np.zeros((k, cfg.context_dim), np.float32)}
            batch = make_global_batch(mesh, local, device)
            m = train_step(cfg, state, batch, generator=mesh.generator(cfg.seed + it),
                           mesh=mesh)
            it += 1
            if steps and it >= steps:
                break
        if mesh.rank == 0:
            print(f"epoch {epoch} | elbo {float(m['elbo']):.4f} | skipped "
                  f"{int(m['skipped'])} | {time.time() - t0:.1f}s", flush=True)
        if steps and it >= steps:
            break
    if mesh.rank == 0:
        print("multihost run ok", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
