#!/usr/bin/env python
"""MFU and step-time report of an HVAE training config on the GPU: the
port's twin of ``tools/mfu.py``.

Reports ms a step (best and median over windows of synchronised steps), the
FLOPs of one train step and the model FLOPs utilisation against the H100
data sheet's dense peaks (SXM part, 700 W): 989 TFLOP/s in bf16, 495 in TF32
(float32 convs while cuDNN may use TF32, PyTorch's default) and 67 in float32
outside the tensor cores (TF32 off). The FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` over one step: it counts the
matmuls and convolutions only (a conv's backward as a conv for the input's
gradient and one for the weight's, where each is computed), where XLA's cost
analysis behind ``tools/mfu.py`` counts every operation. Every figure is
printed with the card's name and power limit (``nvidia-smi``). It needs a
CUDA device.

Usage:
  python tools/mfu_torch.py --hps ukbb192 --bs 128 [--stage_scan --remat]
  python tools/mfu_torch.py --hps morphomnist --bs 256 --trace_dir /tmp/tr
  python tools/trace_ops_torch.py /tmp/tr
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

H100_PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
STEP_SCOPE = "train_step"


def card() -> str:
    """The card's ``name, power.limit`` as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def peak_key(cfg) -> str:
    """Which peak a step of ``cfg`` is held to: its conv dtype, and for
    float32 whether cuDNN may run the convs in TF32."""
    if cfg.dtype == "bfloat16":
        return "bfloat16"
    return "tf32" if torch.backends.cudnn.allow_tf32 else "float32"


def synth_batch(cfg, device, seed: int = 0):
    """A loader batch of cfg.bs uint8 images and parents in [-1, 1], from a seed."""
    from causal_gen_tpu_torch.train.vae_trainer import to_device

    rng = np.random.default_rng(seed)
    shape = (cfg.bs, *(cfg.input_res,) * cfg.spatial_dims, cfg.input_channels)
    return to_device({"x": rng.integers(0, 256, shape).astype(np.uint8),
                      "pa": rng.uniform(-1, 1, (cfg.bs, cfg.context_dim)).astype(np.float32)},
                     device)


def step_flops(cfg, state, batch, generator) -> float:
    """FLOPs of one train step (it updates ``state``) as FlopCounterMode
    counts them: matmuls and convolutions, forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    from causal_gen_tpu_torch.train.vae_trainer import train_step

    with FlopCounterMode(display=False) as counter:
        train_step(cfg, state, batch, generator=generator)
    return float(counter.get_total_flops())


def measure(cfg, windows: int = 12, iters: int = 5, trace_dir: str = "", seed: int = 0):
    """The report of ``cfg``'s train step on the card: ms a step, FLOPs,
    MFU; with ``trace_dir``, 4 more steps traced there (each inside the
    ``train_step`` scope) and their device ms."""
    from causal_gen_tpu_torch import resolve_device
    from causal_gen_tpu_torch.models.simple_vae import build_vae
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import train_step
    from causal_gen_tpu_torch.utils import profiling

    device = resolve_device("cuda")
    gen = torch.Generator().manual_seed(seed)
    model = build_vae(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    state = init_train_state(cfg, model)
    batch = synth_batch(cfg, device, seed)

    t0 = time.perf_counter()
    train_step(cfg, state, batch, generator=gen)  # warm-up: kernels built, cuDNN plans
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    flops = step_flops(cfg, state, batch, gen)

    dts = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            m = train_step(cfg, state, batch, generator=gen)
        profiling.synchronize(m)
        dts.append((time.perf_counter() - t0) / iters)
    best, med = min(dts), statistics.median(dts)
    key = peak_key(cfg)
    peak = H100_PEAK_FLOPS[key]
    report = {
        "card": card(), "hps": cfg.name, "bs": cfg.bs, "dtype": cfg.dtype, "peak": key,
        "stage_scan": cfg.stage_scan, "remat": cfg.remat, "params_m": n_params / 1e6,
        "first_step_s": first_s, "ms_per_step_best": best * 1e3,
        "ms_per_step_median": med * 1e3, "img_per_sec_best": cfg.bs / best,
        "flops_per_step_g": flops / 1e9, "mfu_best_pct": 100.0 * flops / best / peak,
    }
    if trace_dir:
        from tools.device_time_torch import scope_ms

        n_traced = 4
        with profiling.trace(trace_dir):
            for _ in range(n_traced):
                with profiling.annotate(STEP_SCOPE):
                    m = train_step(cfg, state, batch, generator=gen)
            profiling.synchronize(m)
        device_ms = scope_ms(trace_dir, STEP_SCOPE) / n_traced
        report.update(ms_per_step_device=device_ms, img_per_sec_device=cfg.bs / device_ms * 1e3,
                      mfu_device_pct=100.0 * flops / (device_ms / 1e3) / peak)
    return report


def main() -> None:
    from causal_gen_tpu_torch.config import get_config
    from causal_gen_tpu_torch.utils.cache import setup_compilation_cache

    setup_compilation_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--hps", default="morphomnist")
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--beta", type=float, default=None)
    p.add_argument("--z_max_res", type=int, default=None)
    p.add_argument("--stage_scan", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat_min_res", type=int, default=None)
    p.add_argument("--width_multiple", type=int, default=None,
                   help="round conv widths up to this multiple (changes capacity)")
    p.add_argument("--dtype", default=None)
    p.add_argument("--x_like", default=None, help="likelihood override (e.g. diag_dmol)")
    p.add_argument("--windows", type=int, default=12)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--trace_dir", default="", help="also write a profiler trace here")
    args = p.parse_args()

    kw = dict(bs=args.bs, accu_steps=1)
    for k in ("beta", "z_max_res", "dtype", "x_like", "remat_min_res", "width_multiple"):
        v = getattr(args, k)
        if v is not None:
            kw[k] = v
    if args.stage_scan:
        kw["stage_scan"] = True
    if args.remat:
        kw["remat"] = True
    print(json.dumps(measure(get_config(args.hps, **kw), args.windows, args.iters,
                             args.trace_dir)))


if __name__ == "__main__":
    main()
