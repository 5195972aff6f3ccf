#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels against their
plain versions.

    python3 chip_smoke.py [--json PATH]

Phases, one progress line each:
  1. device  - the card's name and power limit (nvidia-smi)
  2. build   - nvcc builds every kernel of the port (one process per source)
  3. K1      - fused_sample_kl against its plain version at every decoder shape
               of the slice and a ragged size; Philox statistics; its time
  4. slice   - DSCM.forward do(thickness) at the full Morpho-MNIST width, bs 32,
               weights and batch from a seed: the main path with the launch
               counts read around it, parity with the CPU plain path on the same
               weights and noise, the null-intervention identity, the
               2-particle variance map, the time per forward, and the
               device time by kernel under torch.profiler
The last two lines are the kernels JSON and the result JSON. Any failure
exits non-zero without the result line; the whole run stops itself after
DEADLINE_S. Needs a CUDA device and the rest of the repository; reads no data
and no checkpoint. With --json, every measurement also goes to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

DEADLINE_S = 600
BS = 32
SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _deadline() -> None:
    print(f"chip_smoke: deadline of {DEADLINE_S} s passed; stopping", file=sys.stderr, flush=True)
    os._exit(124)


def cuda_time_ms(fns, reps: int = 50, per_graph: int = 24) -> float:
    """Median device time of one call: ``per_graph`` calls, cycling through
    ``fns``, are captured in one CUDA graph, so that the card never waits on
    the host, and each of ``reps`` replays is timed with CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"{name}; count {torch.cuda.device_count()}; torch {torch.__version__} "
                  f"cuda {torch.version.cuda}")
    print(smi, flush=True)
    return name, smi


def phase_build():
    from causal_gen_tpu_torch.ops import build

    nvcc = build.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60,
                             check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t0
    for name, path in paths.items():
        log("build", f"{name}: {path} ({secs:.1f} s for all; {nvcc}: {version})")
    return secs


def k1_shapes(cfg):
    from causal_gen_tpu_torch.models.hvae import plan_decoder_blocks

    res = sorted({r for r, _ in plan_decoder_blocks(cfg) if r <= cfg.z_max_res})
    return [(BS, cfg.z_dim, r, r) for r in res]


def phase_k1(cfg):
    import torch

    from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl, fused_sample_kl_ref

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)

    def inputs(shape):
        return [(torch.randn(shape, generator=g) * s).to(dev) for s in (1.0, 0.3, 1.0, 0.3)]

    max_err = 0.0
    for shape in k1_shapes(cfg) + [(1_000_003,)]:
        args = inputs(shape)
        eps = torch.randn(shape, generator=g).to(dev)
        z, kl = fused_sample_kl(*args, eps=eps)
        z_r, kl_r = fused_sample_kl_ref(*args, eps)
        torch.cuda.synchronize()
        for got, ref in ((z, z_r), (kl, kl_r)):
            err = (got - ref).abs()
            if not torch.all(err <= 1e-6 * (1 + ref.abs())):
                raise AssertionError(f"K1 disagrees with its plain version at {shape}: "
                                     f"max err {err.max().item():.3e}")
            max_err = max(max_err, err.max().item())
    log("K1", f"injected eps: kernel == plain version within 1e-6*(1+|ref|) at "
              f"{k1_shapes(cfg)} and (1000003,); max abs err {max_err:.3e}")

    zeros = torch.zeros(1 << 22, device=dev)
    draw = lambda seed: fused_sample_kl(  # noqa: E731 - z = eps when q = 0
        zeros, zeros, zeros, zeros, generator=torch.Generator().manual_seed(seed))[0]
    e1, e1b, e2 = draw(1), draw(1), draw(2)
    mean, std = e1.mean().item(), e1.std().item()
    if not (abs(mean) < 5e-3 and abs(std - 1) < 5e-3):
        raise AssertionError(f"Philox eps off: mean {mean:.3e} std {std:.5f}")
    if not torch.equal(e1, e1b) or torch.equal(e1, e2):
        raise AssertionError("Philox stream: same seed must repeat, another seed must differ")
    log("K1", f"Philox: 2^22 draws mean {mean:.2e} std {std:.5f}; same seed identical, "
              f"other seed differs")

    shape = k1_shapes(cfg)[-1]
    n = 1
    for d in shape:
        n *= d
    # 8 input sets (118 MB) taken in turn overflow the 50 MB L2, so these
    # times are from device memory, the case the bound describes; the main
    # path finds K1's inputs in L2 (its posterior conv has just written them),
    # which ms_l2 times on one set
    sets = [(inputs(shape), torch.randn(shape, generator=g).to(dev)) for _ in range(8)]
    ms = cuda_time_ms([lambda a=a, e=e: fused_sample_kl(*a, eps=e) for a, e in sets])
    plain_ms = cuda_time_ms([lambda a=a, e=e: fused_sample_kl_ref(*a, e) for a, e in sets])
    philox_ms = cuda_time_ms([lambda a=a: fused_sample_kl(*a) for a, _ in sets])
    ms_l2 = cuda_time_ms([lambda: fused_sample_kl(*sets[0][0], eps=sets[0][1])])
    # bytes: 4 inputs (+ eps) read once, z and kl written once; operations: 13
    # float32 ops an element (2 exp, 5 mul, 5 add/sub, 1 div)
    def bound(nbytes_per_elem):
        return max(nbytes_per_elem * n / HBM_BYTES_PER_S, 13 * n / FP32_FLOPS_PER_S) * 1e3

    bound_ms, bound_philox_ms = bound(28), bound(24)
    log("K1", f"{shape} ({n} elements), from device memory: kernel {ms * 1e3:.2f} us "
              f"(bound {bound_ms * 1e3:.2f} us, 28 B/elem), in-kernel Philox "
              f"{philox_ms * 1e3:.2f} us (bound {bound_philox_ms * 1e3:.2f} us, 24 B/elem), "
              f"plain version {plain_ms * 1e3:.2f} us; kernel with inputs in L2 "
              f"{ms_l2 * 1e3:.2f} us")
    return {"max_abs_err": max_err, "ms": ms, "ms_l2": ms_l2, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "ms_philox": philox_ms, "bound_ms_philox": bound_philox_ms, "shape": list(shape),
            "philox_mean": mean, "philox_std": std}


def build_slice(cfg, device, state=None):
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.pgm.dscm import DSCM
    from causal_gen_tpu_torch.pgm.flow_pgm import MorphoMNISTPGM

    g = torch.Generator().manual_seed(SEED)
    vae = HVAE(cfg, device=device, generator=g)
    pgm = MorphoMNISTPGM(setup_predictors=False, device=device, generator=g)
    pred = MorphoMNISTPGM(setup_predictors=True, input_res=cfg.input_res, device=device,
                          generator=g)
    if state is not None:
        for mod, sd in zip((vae, pgm, pred), state):
            mod.load_state_dict(sd)
    # as tests/test_dscm.py::build_dscm builds the JAX one
    return DSCM(cfg, pgm, pred, vae, elbo_constraint=1.8, lmbda_init=0.0, damping=100.0)


def synth_obs(cfg, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    res = cfg.input_res
    obs = {
        "x": rng.uniform(-1, 1, (BS, 1, res, res)),
        "thickness": rng.uniform(-0.8, 0.8, (BS, 1)),
        "intensity": rng.uniform(-0.8, 0.8, (BS, 1)),
        "digit": np.eye(10)[rng.integers(0, 10, BS)],
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in obs.items()}


def phase_slice(cfg):
    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import plan_decoder_blocks
    from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dscm = build_slice(cfg, "cuda")
    obs = synth_obs(cfg, dev)
    do = {"thickness": torch.full((BS, 1), 0.5, device=dev)}
    stochastic = [r for r, _ in plan_decoder_blocks(cfg) if r <= cfg.z_max_res]
    g = torch.Generator().manual_seed(SEED + 1)

    with torch.inference_mode():
        # the main path: counts set to 0 just before, read just after
        fused_sample_kl.launches = 0
        out = dscm.forward(obs, do, generator=g)
        torch.cuda.synchronize()
        launches = fused_sample_kl.launches
        expected = 2 * len(stochastic)  # factual pass + abduction, one particle
        if launches != expected:
            raise AssertionError(f"K1 launched {launches} times on the main path, "
                                 f"expected {expected}")
        cf_x = out["cfs"]["x"]
        if cf_x.shape != obs["x"].shape or not torch.isfinite(cf_x).all() \
                or cf_x.abs().max() > 1 or not all(torch.isfinite(out[k]) for k in
                                                   ("elbo", "nll", "kl", "aux_loss", "loss")):
            raise AssertionError("main path: cf_x or a loss term is malformed")
        log("slice", f"main path DSCM.forward do(thickness) bs {BS}: K1 launched {launches} "
                     f"times ({len(stochastic)} stochastic blocks x 2 passes); "
                     f"elbo {out['elbo'].item():.5f}")

        # parity with the CPU plain path: same weights, batch and noise
        rng = np.random.default_rng(SEED + 2)
        noise = [rng.standard_normal((BS, cfg.z_dim, r, r)).astype(np.float32)
                 for r in stochastic * 2]
        gpu = dscm.forward(obs, do, noise=[torch.from_numpy(e).to(dev) for e in noise])
        cpu_dscm = build_slice(cfg, "cpu", state=[
            {k: v.cpu() for k, v in m.state_dict().items()}
            for m in (dscm.vae, dscm.pgm, dscm.predictor)])
        cpu_obs = {k: v.cpu() for k, v in obs.items()}
        cpu = cpu_dscm.forward(cpu_obs, {k: v.cpu() for k, v in do.items()},
                               noise=[torch.from_numpy(e) for e in noise])
        cf_err = (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs().max().item()
        rel = {k: abs(gpu[k].item() - cpu[k].item()) / abs(cpu[k].item())
               for k in ("elbo", "kl", "nll")}
        if cf_err > 1e-4 or max(rel.values()) > 1e-4:
            raise AssertionError(f"card vs CPU: cf_x err {cf_err:.3e}, rel {rel}")
        log("slice", f"card == CPU plain path (TF32 off): cf_x max abs err {cf_err:.3e}; "
                     + ", ".join(f"{k} rel err {v:.3e}" for k, v in rel.items()))

        null = dscm.forward(obs, {"thickness": obs["thickness"]}, generator=g)
        null_err = (null["cfs"]["x"] - obs["x"]).abs().max().item()
        if null_err > 1e-4:
            raise AssertionError(f"null intervention: |cf_x - x| = {null_err:.3e}")
        log("slice", f"null intervention do(thickness = observed): max |cf_x - x| {null_err:.3e}")

        two = dscm.forward(obs, do, cf_particles=2, generator=g)
        var = two["var_cf_x"]
        if var is None or not torch.isfinite(var).all() or var.min() < 0:
            raise AssertionError("2-particle var_cf_x must be finite and >= 0")
        log("slice", f"2 particles: var_cf_x finite, min {var.min().item():.3e}, "
                     f"max {var.max().item():.3e}")

        for _ in range(3):
            dscm.forward(obs, do, generator=g)
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dscm.forward(obs, do, generator=g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof = profile_forward(lambda: dscm.forward(obs, do, generator=g))
    ms = statistics.median(times)
    log("slice", f"DSCM.forward bs {BS}: median {ms:.3f} ms over 20 calls "
                 f"(min {min(times):.3f}, max {max(times):.3f}) = {BS / ms * 1e3:.1f} cf/s")
    return {"profile": prof, "launches": launches, "cf_x_err": cf_err, "rel_err": rel,
            "null_err": null_err, "forward_ms": ms, "forward_ms_all": times,
            "cf_per_s": BS / ms * 1e3}


def profile_forward(fn, calls: int = 3):
    """Device time by kernel over ``calls`` forwards under torch.profiler, and
    the device's busy share of the wall time of that window (the profiler's
    own host cost included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}  # the device's own events: a host op's device time is theirs
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            kernels[evt.key] = (evt.self_device_time_total / calls, evt.count // calls)
    device_us = sum(t for t, _ in kernels.values())
    if device_us == 0:
        log("profile", "torch.profiler recorded no device time: busy share not measured")
        return {"device_ms_per_forward": None}
    k1_us = sum(t for k, (t, _) in kernels.items() if "sample_kl" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"wall_ms_per_forward": wall_us / calls / 1e3,
           "device_ms_per_forward": device_us / 1e3,
           "device_busy_share": device_us * calls / wall_us,
           "kernel_launches_per_forward": sum(c for _, c in kernels.values()),
           "k1_device_ms_per_forward": k1_us / 1e3,
           "top": [(k[:80], t / 1e3, c) for k, (t, c) in top]}
    log("profile", f"per forward under the profiler: wall {out['wall_ms_per_forward']:.2f} ms, "
                   f"device busy {out['device_ms_per_forward']:.2f} ms "
                   f"({out['device_busy_share']:.1%}), {out['kernel_launches_per_forward']} "
                   f"device kernels and copies, K1 {out['k1_device_ms_per_forward'] * 1e3:.1f} us")
    for k, t, c in out["top"]:
        log("profile", f"  {t * 1e3:9.1f} us  x{c:<5d} {k}")
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write every measurement to this file")
    args = ap.parse_args()
    timer = threading.Timer(DEADLINE_S, _deadline)
    timer.daemon = True
    timer.start()
    t_start = time.perf_counter()
    name, smi = phase_device()
    sys.path.insert(0, ROOT)
    from causal_gen_tpu_torch.config import get_config

    cfg = get_config("morphomnist", bs=BS)
    build_s = phase_build()
    k1 = phase_k1(cfg)
    sl = phase_slice(cfg)
    kernels = [{
        "name": "fused_sample_kl", "route": "cuda",
        "source": "causal_gen_tpu_torch/csrc/sample_kl.cu",
        "replaces": "causal_gen_tpu/ops/pallas_kernels.py:109",
        "launches": sl["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "ms_inputs_in_l2": k1["ms_l2"],
        "ms_philox": k1["ms_philox"], "bound_ms_philox": k1["bound_ms_philox"],
        "held_by": "phase K1 (injected eps at every slice shape + ragged; Philox statistics)",
    }]
    record = {"device": name, "nvidia_smi": smi, "build_s": build_s, "k1": k1, "slice": sl,
              "kernels": kernels, "total_s": time.perf_counter() - t_start}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    log("done", f"all phases passed in {record['total_s']:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    timer.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
