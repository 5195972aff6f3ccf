#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels against their
plain versions.

    python3 chip_smoke.py [--json PATH] [--parent DIR]
    python3 chip_smoke.py --tune-k2

Phases, one progress line each:
  1. device  - the card's name and power limit (nvidia-smi)
  2. build   - nvcc builds every kernel of the port (one process per source,
               all started together)
  3. K1      - fused_sample_kl against its plain version at every decoder shape
               of the slice and a ragged size; Philox statistics; its time
  4. K1-bwd  - its backward kernel against autograd of the plain version at
               the same shapes, with injected eps and on the Philox path; its time
  5. K3      - the DMoL loss kernels, forward and backward, against the plain op
               and its autograd at (32,100,32,32) and at a ragged size with
               pixels at -1, 1 and the 1e-5 switch, low_bit False and True;
               their launch plans, registers, spills and SASS instruction floor;
               their times and a digest of their outputs
  6. K4      - the DMoL sampler against its plain version with the same
               uniforms at (32,100,32,32) and a ragged size, t 0.3 and 1; Philox
               statistics over 2^20 pixels (mixture frequencies, KS of a
               channel); its launch plans; its time in both modes against the
               bytes this run's picks need, and a digest of its outputs
  6b. K2     - the fused light block against its plain version at all seven
               ukbb192 block shapes and at shapes whose C and b are not
               multiples of 16, whose batch leaves a block of several images
               short and whose weights do not fit beside a tile, in float32
               (the CUDA-core kernel, TF32 off) and bf16 (the tensor-core
               kernel), and at ukbb64's six shapes in float32, with and
               without biases; each kernel's time at every shape of its main
               path beside the bound, the plain version and the cuDNN conv
               pair, summed over a DSCM.forward's and an HVAE.sample's
               launches: bf16 at ukbb192's shapes, float32 at ukbb64's and
               ukbb192's
  7. slice   - DSCM.forward do(thickness) at the full Morpho-MNIST width, bs 32,
               weights and batch from a seed: the main path with the launch
               counts read around it, parity with the CPU plain path on the same
               weights and noise, the null-intervention identity, the
               2-particle variance map, the time per forward, and the
               device time by kernel under torch.profiler
  8. sample  - HVAE.sample and forward_latents on the card with a CPU
               generator (morphomnist); HVAE.sample(return_loc=False, t=0.7) on
               cmnist with the diag_dmol head at full width, bs 32: the main
               path with the launch counts read around it, card against the CPU
               plain path in both modes with the draws injected (and on
               morphomnist), its time and the profiler; DSCM.forward with
               t_abduct=0.1, card against CPU
  9. train   - for morphomnist and for cmnist with the diag_dmol head, at full
               width, bs 32: three updates and one step forced to skip, card
               against the CPU plain path from the same weights, batches and
               noise; the launch counts around one step; the time of a step
               (and at bs 256 for morphomnist); device time under the profiler
  10. entry  - train() through cli.main on each configuration with an
               in-memory dataset made from the seed: 2 epochs of 3 batches, one
               evaluation, a checkpoint written and read back; the launch
               counts around it are the kernels line's
  11. ukbb   - DSCM.forward do(ventricle_volume) on ukbb192 in bf16 at full
               width and depth, bs 32, weights and batch from a seed, under
               inference_mode: the main path with K2's and K1's launch counts
               against the config's; card against the CPU plain path at bs 2
               in float32 (1e-4; K2's SIMT kernel, its launches counted) and
               in bf16 (the transfer's bound); the time of a forward and the
               profiler
  12. ukbb-sample - HVAE.sample(return_loc=False, t=0.7) on ukbb192 in bf16,
               bs 32: K2 on every covered decoder block; card against CPU in
               float32 at bs 2 with the draws injected; its time
  13. ukbb-train  - the ukbb192 train step in bf16, bs 32: no K2 launch;
               the first step card against CPU in float32 at bs 2; its time
  14. ukbb64 - DSCM.forward do(ventricle_volume) on the registry's ukbb64
               (float32) at full width and depth, bs 32, under inference_mode:
               the main path with K2's float32 kernel launched 362 times and
               K1's count from the config, card against the CPU plain path at
               bs 2 (1e-4, noise injected), the time of a forward, the profiler
  15. mimic  - DSCM.forward on the mimic192 flagship's configuration (the
               registry's mimic192 with the flagship's z_max_res 96, beta and
               posterior init; bf16, GELU blocks, so K2 covers no block) with
               ChestPGM as PGM and as the ResNet-18 predictor, weights from the
               seed: K1 against its plain version at the path's shapes
               (injected eps); card against the CPU plain path at bs 2 in
               float32 (1e-4)
               and bf16 (the transfer's bound) under do(age) and
               do(finding = 1 - finding), the posterior normals and both Gumbel
               draws injected; the main path do(age) at bs 32 under
               inference_mode with K1's 76 launches and no other; the time of a
               forward, the profiler, the trunk's device time
  16. cond_prior - the registry's morphomnist at full width, float32, with
               cond_prior (checkpoints/final_morpho_cp's configuration:
               cond_drop_from 2) and with q_correction, seeded weights with
               the zero heads filled: card against the CPU plain path at bs 2
               with every draw injected (DSCM.forward do(thickness) 1e-4; the
               mixture abduction at alpha 0.65, 1e-4; one train step for each
               dropout option 0/1/2, or one for q_correction, metrics 1e-4 rel
               and parameters within 2 lr); the main paths at bs 32 with their
               launch counts (DSCM.forward K1 40, the mixture abduction K1 20,
               a train step K1 + K1-bwd 20 + 20, K2 none); cond_prior's
               forward (inference_mode) and step times, the profiler
  17. vol3d  - the registry's vol3d32 (3-D, bf16, bs 8): K1 and K1-bwd
               against their plain versions at (8,8,r,r,r), r in {1,4,8,16,32}
               (the KL's cotangent stride 0 over (D,H,W)); card against the
               CPU plain path at bs 2 in bf16 (the transfer's bound; ELBO
               terms 2e-2) and float32 (1e-4): the HVAE counterfactual
               (ELBO, abduct, forward_latents under the parents and
               do(radius)), HVAE.sample(t=0.7), one train step; the main paths
               with their launch counts (counterfactual K1 20, train step
               K1 + K1-bwd 10 + 10, sample none; K2 0 on each: 3-D blocks run
               Conv3d); the counterfactual's and the step's times, the profiler
  18. turns  - with --parent DIR (an earlier tree of the repository, unpacked):
               that tree's K2 float32 kernel at every ukbb shape, K4 in both
               modes and ukbb64 forward against this tree's, in turns (parent,
               this, this, parent), each a process of its own; K4's output
               digests must agree
With --tune-k2 it only times the float32 K2 kernel's best candidate launches
at every ukbb shape (tune_k2) and prints the fastest as a table.
The last two lines are the kernels JSON and the result JSON. Any failure
exits non-zero without the result line; the whole run stops itself after
DEADLINE_S. Needs a CUDA device and the rest of the repository; reads no data
and no checkpoint.
With --json, every measurement also goes to PATH.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

DEADLINE_S = 1100  # the run must end within 1200 s, the kernels' build included
BS = 32
BENCH_BS = 256  # bench.py's Morpho-MNIST train step
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


def forward_times(dscm, obs, do, g, n=20):
    """Host-clock ms of ``n`` synchronized forwards after 3 warm-up calls."""
    import torch

    for _ in range(3):
        dscm.forward(obs, do, generator=g)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dscm.forward(obs, do, generator=g)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


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


def k1_res(cfg):
    """The resolution of each stochastic decoder block, in order."""
    from causal_gen_tpu_torch.models.hvae import plan_decoder_blocks

    return [r for r, _ in plan_decoder_blocks(cfg) if r <= cfg.z_max_res]


def k1_shapes(cfg):
    return [(BS, cfg.z_dim, r, r) for r in sorted(set(k1_res(cfg)))]


def k1_check(shapes, g):
    """K1 (``fused_sample_kl``) against its plain version on the card at each
    of ``shapes``, inputs and eps from ``g``: z and kl within
    1e-6 (1 + |ref|). Returns the largest abs error."""
    import torch

    from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl, fused_sample_kl_ref

    dev = torch.device("cuda")
    max_err = 0.0
    for shape in shapes:
        args = [(torch.randn(shape, generator=g) * s).to(dev) for s in (1.0, 0.3, 1.0, 0.3)]
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
    return max_err


def phase_k1(cfg):
    import torch

    from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl, fused_sample_kl_ref

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)

    def inputs(shape):
        return [(torch.randn(shape, generator=g) * s).to(dev) for s in (1.0, 0.3, 1.0, 0.3)]

    max_err = k1_check(k1_shapes(cfg) + [(1_000_003,)], g)
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


def k1_bwd_check(shapes, g):
    """K1-bwd against autograd of K1's plain version on the card at each of
    ``shapes``, inputs from ``g``, with injected eps and on the Philox path
    (its eps recovered from z): every cotangent within 1e-5 (1 + |ref|). The
    KL is summed over every spatial axis as the HVAE sums it, so its
    cotangent reaches the backward as a stride-0 broadcast (over (H, W), or
    (D, H, W) for a volume). Returns the largest abs error."""
    import torch

    from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl, fused_sample_kl_ref

    dev = torch.device("cuda")

    def grads(fn, args, w, v):
        leaves = [a.clone().requires_grad_() for a in args]
        z, kl = fn(*leaves)
        red = kl.sum(dim=tuple(range(2, kl.dim()))) if kl.dim() > 2 else kl
        return torch.autograd.grad((z * w).sum() + (red * v).sum(), leaves)

    max_err = 0.0
    for shape in shapes:
        args = [(torch.randn(shape, generator=g) * s).to(dev) for s in (1.0, 0.3, 1.0, 0.3)]
        w = torch.randn(shape, generator=g).to(dev)
        v = torch.randn(shape[:2] if len(shape) > 2 else shape, generator=g).to(dev)
        eps = torch.randn(shape, generator=g).to(dev)
        seed = torch.Generator().manual_seed(SEED + 6)
        z_ph, _ = fused_sample_kl(*args, generator=seed)
        eps_ph = (z_ph - args[0]) / torch.exp(args[1])  # Philox's eps, recovered
        for name, kernel, e in (
                ("injected eps", lambda *a, e=eps: fused_sample_kl(*a, eps=e), eps),
                ("Philox", lambda *a: fused_sample_kl(
                    *a, generator=torch.Generator().manual_seed(SEED + 6)), eps_ph)):
            got = grads(kernel, args, w, v)
            ref = grads(lambda *a, e=e: fused_sample_kl_ref(*a, e), args, w, v)
            torch.cuda.synchronize()
            for gk, gr in zip(got, ref):
                err = (gk - gr).abs()
                if not torch.all(err <= 1e-5 * (1 + gr.abs())):
                    raise AssertionError(f"K1-bwd ({name}) disagrees with autograd of the plain "
                                         f"version at {shape}: max err {err.max().item():.3e}")
                max_err = max(max_err, err.max().item())
    return max_err


def phase_k1_bwd(cfg):
    import torch

    from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl_bwd, fused_sample_kl_bwd_ref

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED + 5)

    def inputs(shape):
        return [(torch.randn(shape, generator=g) * s).to(dev) for s in (1.0, 0.3, 1.0, 0.3)]

    max_err = k1_bwd_check(k1_shapes(cfg) + [(1_000_003,)], g)
    log("K1-bwd", f"kernel == autograd of the plain version within 1e-5*(1+|ref|), injected "
                  f"eps and Philox, at {k1_shapes(cfg)} and (1000003,); max abs err {max_err:.3e}")

    shape = k1_shapes(cfg)[-1]
    n = math.prod(shape)
    rows = shape[0] * shape[1]
    # 8 sets of 6 full-size tensors (100 MB) overflow the 50 MB L2: from device memory
    sets = []
    for _ in range(8):
        args = inputs(shape)
        z = torch.randn(shape, generator=g).to(dev)
        gz = torch.randn(shape, generator=g).to(dev)
        gkl = torch.randn(shape[:2], generator=g).to(dev)[:, :, None, None].expand(shape)
        sets.append((args, z, gz, gkl))
    ms = cuda_time_ms([lambda a=a, z=z, gz=gz, gk=gk: fused_sample_kl_bwd(*a, z, gz, gk)
                       for a, z, gz, gk in sets])
    plain_ms = cuda_time_ms([lambda a=a, z=z, gz=gz, gk=gk: fused_sample_kl_bwd_ref(*a, z, gz, gk)
                             for a, z, gz, gk in sets])
    # bytes: q_loc, q_logscale, p_loc, p_logscale, z, gz read once (24 B an
    # element), gkl once per (batch, channel), four cotangents written (16 B);
    # operations: 18 float32 ops an element (2 exp)
    nbytes = 40 * n + 4 * rows
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 18 * n / FP32_FLOPS_PER_S) * 1e3
    log("K1-bwd", f"{shape} ({n} elements), from device memory: kernel {ms * 1e3:.2f} us "
                  f"(bound {bound_ms * 1e3:.2f} us, {nbytes / n:.2f} B/elem), plain version "
                  f"{plain_ms * 1e3:.2f} us")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bytes": nbytes, "shape": list(shape)}


def k3_inputs(b, h, w, device, seed=SEED, narrow=True):
    """NCHW x (b,3,h,w) on the 8-bit grid and l (b,100,h,w) ~ N(0, 1) for K3.
    Row 0 of red is -1 and row 1 of green is 1 (the edge branches). With
    ``narrow``, log-scales run from below the -7 floor to 1, and column 0 from
    row 2 down puts every component at log-scale -6.9 (off the floor's tie,
    where XLA's clip passes half the gradient) with inv*u spread over
    [14, 18], so that cdf_delta crosses the 1e-5 switch there."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = ((rng.integers(0, 256, (b, 3, h, w)) - 127.5) / 127.5).astype(np.float32)
    x[:, 0, 0, :] = -1.0
    x[:, 1, 1, :] = 1.0
    l = rng.normal(0, 1, (b, 100, h, w)).astype(np.float32)
    if narrow:
        for c in range(3):
            l[:, 20 + 30 * c: 30 + 30 * c] = rng.uniform(-7.5, 1.0, (b, 10, h, w))
    if narrow and h > 2:
        x[:, :, 2:, 0] = 0.2
        v = np.linspace(14.0, 18.0, b * (h - 2) * 10).reshape(b, 10, h - 2)
        for c in range(3):
            base = 10 + 30 * c
            l[:, base: base + 10, 2:, 0] = 0.2 - v * np.exp(-6.9)
            l[:, base + 10: base + 20, 2:, 0] = -6.9
            l[:, base + 20: base + 30, 2:, 0] = 0.0  # tanh(0): no coupling
    return torch.from_numpy(x).to(device), torch.from_numpy(l).to(device)


def k3_grad_close(got, ref) -> bool:
    """The K3 gradient tolerance: 1e-5 |ref| + 1e-6 max |ref| per element.
    Kernel and autograd evaluate d/du as a difference of two terms in
    another order; where those cancel, the error scales with the terms (the
    tensor's scale), not with the small result."""
    return bool(torch_all_close(got, ref, 1e-5, 1e-6 * ref.abs().max().item()))


def torch_all_close(got, ref, rtol, atol):
    return ((got - ref).abs() <= atol + rtol * ref.abs()).all().item()


SMS = 132  # H100 SXM streaming multiprocessors
WARP_INSTRUCTIONS_PER_SM_CLOCK = 4  # one a clock in each of an SM's 4 sub-partitions


def sass_phases(sass, kernel):
    """Instruction counts of the kernel whose mangled name contains
    ``kernel`` in ``cuobjdump -sass`` text: the instructions up to its last
    EXIT (the slow-path subroutines placed after it left out), NOPs left out,
    split at each BAR.SYNC into phases. Returns [(instructions, MUFU)] a
    phase. Every branch is counted: a warp whose threads take one side of a
    branch runs fewer, a warp whose threads split runs both."""
    import re

    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel not in func.split()[0]:
            continue
        ops = [m for m in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                     func) if m != "NOP"]
        ops = ops[:max(i for i, op in enumerate(ops) if op == "EXIT") + 1]
        cuts = [0] + [i + 1 for i, op in enumerate(ops) if op.startswith("BAR.SYNC")] + [len(ops)]
        return [(b - a, sum(op.startswith("MUFU") for op in ops[a:b]))
                for a, b in zip(cuts, cuts[1:])]
    raise AssertionError(f"no kernel {kernel} in the SASS")


def k3_resources(src, kernels):
    """Registers, spills and the SASS instruction count of K3's kernels, from the
    source ``src`` compiled to a cubin with the port's flags, ``nvcc
    --resource-usage`` and ``cuobjdump -sass``. ``kernels`` maps a name part
    of each kernel to the threads a pixel of each of its phases (one thread
    a pixel: [1]; one a (mixture, pixel) with a per-pixel reduction between
    barriers: [10, 1] or [10, 1, 10]). Returns, per kernel: registers, spill
    bytes, instructions and MUFU by phase, and warp instructions a pixel."""
    import re
    import tempfile

    from causal_gen_tpu_torch.ops import build

    nvcc = build.nvcc_path()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k3.cubin")
        usage = subprocess.run([nvcc, *flags, "-cubin", "--resource-usage", "-o", cubin, src],
                               capture_output=True, text=True, timeout=300, check=True)
        sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, timeout=120, check=True).stdout
    text = usage.stdout + usage.stderr
    out = {}
    for kernel, threads in kernels.items():
        block = text[text.index(kernel, text.index("Compiling entry function")):]
        regs = int(re.search(r"Used (\d+) registers", block).group(1))
        stores, loads = map(int, re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                           block).groups())
        phases = sass_phases(sass, kernel)
        if len(phases) != len(threads):
            raise AssertionError(f"{kernel}: {len(phases)} phases in the SASS, {len(threads)} "
                                 "expected")
        out[kernel] = {"registers": regs, "spill_stores": stores, "spill_loads": loads,
                       "instructions_by_phase": [n for n, _ in phases],
                       "mufu_by_phase": [m for _, m in phases], "threads_a_pixel": threads,
                       "warp_instructions_a_pixel": sum(n * t for (n, _), t in
                                                        zip(phases, threads)) / 32}
    return out


def max_sm_clock_hz():
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def k3_time(b, h, w, dev):
    """K3's forward and backward kernels and their plain versions at (b, 100,
    h, w) from device memory: 8 input sets (105 MB of l) overflow the 50 MB
    L2. Also the SHA-256 of the kernels' outputs on those sets, so that two
    trees' kernels can be held bit for bit against each other."""
    import hashlib

    import torch

    from causal_gen_tpu_torch.ops.dmol import dmol_logprob_pixels
    from causal_gen_tpu_torch.ops.dmol_loss import dmol_logprob, dmol_loss_bwd, dmol_loss_bwd_ref

    sets = [k3_inputs(b, h, w, device=dev, seed=SEED + 10 + i) for i in range(8)]
    gs = [torch.randn(b, generator=torch.Generator().manual_seed(i)).to(dev) for i in range(8)]
    fwd = [lambda x=x, l=l: dmol_logprob(x, l) for x, l in sets]
    bwd = [lambda x=x, l=l, g=g: dmol_loss_bwd(x, l, g) for (x, l), g in zip(sets, gs)]
    out = {"fwd_ms": cuda_time_ms(fwd),
           "fwd_plain_ms": cuda_time_ms([lambda x=x, l=l: dmol_logprob_pixels(x, l)
                                         for x, l in sets]),
           "bwd_ms": cuda_time_ms(bwd),
           "bwd_plain_ms": cuda_time_ms([lambda x=x, l=l, g=g: dmol_loss_bwd_ref(x, l, g)
                                         for (x, l), g in zip(sets, gs)])}
    for key, fns in (("fwd_sha256", fwd), ("bwd_sha256", bwd)):
        digest = hashlib.sha256()
        for fn in fns:
            digest.update(fn().cpu().numpy().tobytes())
        out[key] = digest.hexdigest()
    return out


def phase_k3():
    import torch

    from causal_gen_tpu_torch.ops import build
    from causal_gen_tpu_torch.ops.dmol import discretized_mix_logistic_loss, dmol_logprob_pixels
    from causal_gen_tpu_torch.ops.dmol_loss import dmol_logprob, dmol_loss, plan

    dev = torch.device("cuda")
    err_fwd = err_bwd = 0.0
    shapes = [(BS, 32, 32), (3, 7, 13)]
    for low_bit in (False, True):
        for shape in shapes:
            x, l = k3_inputs(*shape, device=dev)
            lp, lp_ref = dmol_logprob(x, l, low_bit), dmol_logprob_pixels(x, l, low_bit)
            loss = dmol_loss(x, l, low_bit)
            loss_ref = discretized_mix_logistic_loss(x, l, low_bit)
            torch.cuda.synchronize()
            for got, ref, what in ((lp, lp_ref, "per-pixel log-prob"), (loss, loss_ref, "loss")):
                if not torch_all_close(got, ref, 1e-5, 1e-5):
                    raise AssertionError(
                        f"K3 forward ({what}) disagrees with the plain op at {shape}, low_bit "
                        f"{low_bit}: max err {(got - ref).abs().max().item():.3e}")
            err_fwd = max(err_fwd, (lp - lp_ref).abs().max().item())
            g = torch.randn(shape[0], generator=torch.Generator().manual_seed(SEED + 7)).to(dev)
            leaf = l.clone().requires_grad_()
            (discretized_mix_logistic_loss(x, leaf, low_bit) * g).sum().backward()
            leaf_k = l.clone().requires_grad_()
            (dmol_loss(x, leaf_k, low_bit) * g).sum().backward()
            torch.cuda.synchronize()
            if not k3_grad_close(leaf_k.grad, leaf.grad):
                raise AssertionError(
                    f"K3 backward disagrees with autograd of the plain op at {shape}, low_bit "
                    f"{low_bit}: max err {(leaf_k.grad - leaf.grad).abs().max().item():.3e} "
                    f"(max |ref| {leaf.grad.abs().max().item():.3e})")
            err_bwd = max(err_bwd, (leaf_k.grad - leaf.grad).abs().max().item())
    log("K3", f"forward == plain op within 1e-5*(1+|ref|), backward == its autograd within "
              f"1e-5|ref| + 1e-6 max|ref|, at {shapes} (pixels at -1, 1 and the 1e-5 switch), "
              f"low_bit False and True; max abs err forward {err_fwd:.3e}, backward "
              f"{err_bwd:.3e}")

    b, h, w = shapes[0]
    pix = b * h * w
    plans = {f"{direction} {s}": plan(s[0] * s[1] * s[2], s[1] * s[2],
                                      backward=direction == "backward")._asdict()
             for direction in ("forward", "backward") for s in shapes}
    for key, pl in plans.items():
        log("K3", f"plan {key}: P {pl['tile']}, {pl['threads']} threads, {pl['blocks']} blocks, "
                  f"{pl['shared_bytes']} B shared, straddles images {pl['straddles']}")
    res = k3_resources(str(build.SOURCES["dmol_loss"]),
                       {"dmol_forward_kernel": [10, 1], "dmol_backward_kernel": [10, 1, 10]})
    clock = max_sm_clock_hz()
    for kernel, r in res.items():
        r["instruction_floor_ms"] = pix * r["warp_instructions_a_pixel"] / (
            SMS * WARP_INSTRUCTIONS_PER_SM_CLOCK * clock) * 1e3
        log("K3", f"{kernel}: {r['registers']} registers, spills {r['spill_stores']} B stored "
                  f"/ {r['spill_loads']} B loaded; SASS instructions by phase "
                  f"{r['instructions_by_phase']} (MUFU {r['mufu_by_phase']}) at "
                  f"{r['threads_a_pixel']} threads a pixel: {r['warp_instructions_a_pixel']:.1f} "
                  f"warp instructions a pixel, every branch counted; at {SMS} SMs x "
                  f"{WARP_INSTRUCTIONS_PER_SM_CLOCK} warp instructions a clock and "
                  f"{clock / 1e6:.0f} MHz "
                  f"{r['instruction_floor_ms'] * 1e3:.2f} us at ({b},100,{h},{w})")
    t = k3_time(b, h, w, dev)
    # bytes: forward reads x (12 B) and l (400 B) and writes the log-prob
    # (4 B) a pixel; backward reads x and l and g (4 B an image) and writes
    # d/dl (400 B). Operations: at least ~1,000 float32 ops a pixel either
    # way, 0.5 us at 67 TFLOP/s, so bytes bound both.
    fwd_bytes, bwd_bytes = 416 * pix, 812 * pix + 4 * b
    fwd_bound = max(fwd_bytes / HBM_BYTES_PER_S, 1000 * pix / FP32_FLOPS_PER_S) * 1e3
    bwd_bound = max(bwd_bytes / HBM_BYTES_PER_S, 1000 * pix / FP32_FLOPS_PER_S) * 1e3
    log("K3", f"({b},100,{h},{w}), from device memory: forward {t['fwd_ms'] * 1e3:.2f} us (bound "
              f"{fwd_bound * 1e3:.2f} us), plain {t['fwd_plain_ms'] * 1e3:.2f} us; backward "
              f"{t['bwd_ms'] * 1e3:.2f} us (bound {bwd_bound * 1e3:.2f} us), plain closed form "
              f"{t['bwd_plain_ms'] * 1e3:.2f} us; outputs sha256 forward {t['fwd_sha256'][:16]} "
              f"backward {t['bwd_sha256'][:16]}")
    fwd_r, bwd_r = res["dmol_forward_kernel"], res["dmol_backward_kernel"]
    return {"fwd": {"max_abs_err": err_fwd, "ms": t["fwd_ms"], "plain_ms": t["fwd_plain_ms"],
                    "bound_ms": fwd_bound, "bytes": fwd_bytes, "sha256": t["fwd_sha256"],
                    "resources": fwd_r},
            "bwd": {"max_abs_err": err_bwd, "ms": t["bwd_ms"], "plain_ms": t["bwd_plain_ms"],
                    "bound_ms": bwd_bound, "bytes": bwd_bytes, "sha256": t["bwd_sha256"],
                    "resources": bwd_r},
            "plans": plans, "sm_clock_hz": clock, "shape": [b, 100, h, w]}


def k4_inputs(b, h, w, device, seed=SEED):
    """NCHW l (b,100,h,w) for K4 and its uniforms: logits ~ N(0, 1), means ~
    N(0, 0.5), log-scales uniform on [-7.3, 0.5] (some under the -7 floor),
    coeffs ~ N(0, 1); u_mix (b,10,h,w) and u (b,3,h,w) in [1e-5, 1 - 1e-5)."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.ops.dmol import uniforms

    rng = np.random.default_rng(seed)
    l = rng.normal(0, 1, (b, 100, h, w))
    for c in range(3):
        base = 10 + 30 * c
        l[:, base: base + 10] = rng.normal(0, 0.5, (b, 10, h, w))
        l[:, base + 10: base + 20] = rng.uniform(-7.3, 0.5, (b, 10, h, w))
    g = torch.Generator().manual_seed(seed)
    cpu = torch.device("cpu")
    u_mix = uniforms((b, 10, h, w), g, cpu).to(device)
    u = uniforms((b, 3, h, w), g, cpu).to(device)
    return torch.from_numpy(l.astype(np.float32)).to(device), u_mix, u


def k4_picks(l, scale, t, nr_mix=10):
    """The mixture each pixel took (B,H,W), read back from the sampler's scale
    output: the k whose three clamped log-scales + log t lie nearest to
    log(scale). Exact where the picked triple differs from every other."""
    import torch

    ls = torch.stack([l[:, 2 * nr_mix + 3 * nr_mix * c: 3 * nr_mix + 3 * nr_mix * c]
                      for c in range(3)], dim=1)
    want = torch.clamp(ls, min=-7.0) + math.log(t)
    return (torch.log(scale)[:, :, None] - want).abs().sum(dim=1).argmin(dim=1)


def k4_clear(l, u_mix, gap, nr_mix=10):
    """Pixels (B,H,W) whose two best perturbed logits differ by more than
    ``gap``: there the pick cannot turn on the last bits of a logit."""
    import torch

    top2 = torch.topk(l[:, :nr_mix] - torch.log(-torch.log(u_mix)), 2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) > gap


def k4_compare(l, u_mix, t, got, ref, gap=1e-5, tol=1e-5):
    """K4 against its plain version on the same uniforms: the same mixture on
    every pixel clear of a near-tie, and x and scale within tol*(1+|ref|)
    there. Returns (pixels excluded, max abs err); raises on a mismatch."""
    from causal_gen_tpu_torch.ops.dmol import gumbel_select

    clear = k4_clear(l, u_mix, gap)
    bad_picks = ((k4_picks(l, got[1], t) != gumbel_select(l, u_mix, 10)) & clear).sum().item()
    err = 0.0
    for g_t, r_t, what in ((got[0], ref[0], "x"), (got[1], ref[1], "scale")):
        diff = (g_t - r_t).abs()
        bad = ((diff > tol * (1 + r_t.abs())) & clear[:, None]).sum().item()
        if bad or bad_picks:
            raise AssertionError(f"K4 disagrees with its plain version at {tuple(l.shape)}, t {t}: "
                                 f"{bad} {what} values over {tol}*(1+|ref|), {bad_picks} picks")
        err = max(err, diff[clear[:, None].expand_as(diff)].max().item())
    return int((~clear).sum().item()), err


def k4_philox_stats(device, b=16, h=256, w=256, seed=SEED):
    """K4 in Philox mode on b*h*w pixels that share one set of logits: each
    mixture's frequency as a z-score against softmax(logits), and the KS
    distance of channel 0 (mean 0, log-scale -3 in every mixture, so that
    its clip cannot bind) from the logistic CDF. Channel 1's log-scale,
    -2 - 0.3 k, tells which mixture a pixel took."""
    import torch

    from causal_gen_tpu_torch.ops.dmol_sample import dmol_sample

    k = torch.arange(10, dtype=torch.float32)
    logits = torch.linspace(-1.5, 1.0, 10)
    vec = torch.zeros(100)
    vec[:10] = logits
    vec[20:30] = -3.0
    vec[50:60] = -2.0 - 0.3 * k
    vec[80:90] = -3.0
    l = vec[None, :, None, None].expand(b, 100, h, w).contiguous().to(device)
    x, scale = dmol_sample(l, 10, 1.0, generator=torch.Generator().manual_seed(seed))
    pick = (torch.log(scale[:, 1])[..., None] - (-2.0 - 0.3 * k).to(device)).abs().argmin(-1)
    n = pick.numel()
    counts = torch.bincount(pick.flatten(), minlength=10).double().cpu()
    p = torch.softmax(logits.double(), 0)
    z = (counts - n * p) / torch.sqrt(n * p * (1 - p))
    x0 = torch.sort(x[:, 0].flatten().double()).values
    cdf = torch.sigmoid(x0 / math.exp(-3.0))
    i = torch.arange(n, device=device, dtype=torch.float64)
    ks = max(((i + 1) / n - cdf).max().item(), (cdf - i / n).max().item())
    again = dmol_sample(l, 10, 1.0, generator=torch.Generator().manual_seed(seed))[0]
    other = dmol_sample(l, 10, 1.0, generator=torch.Generator().manual_seed(seed + 1))[0]
    return {"pixels": n, "max_abs_z": z.abs().max().item(), "z": z.tolist(), "ks": ks,
            "same_seed_repeats": bool(torch.equal(x, again)),
            "other_seed_differs": not torch.equal(x, other)}


def k4_bytes(pick, nr_mix=10):
    """Bytes the sampler must move for these picks (B,H,W): every logit
    (4 nr_mix B a pixel), each 32-B sector of a selected plane (mean,
    log-scale and coeff of 3 channels) that some pixel's pick lies in, and
    x and scale (24 B a pixel)."""
    import torch.nn.functional as F

    b, h, w = pick.shape
    hw = h * w
    if hw % 8:
        raise ValueError("k4_bytes counts 32-B sectors of planes of whole sectors")
    onehot = F.one_hot(pick.reshape(b, hw // 8, 8), nr_mix).any(dim=2)  # (b, sector, k)
    return 4 * nr_mix * b * hw + 9 * 32 * int(onehot.sum().item()) + 24 * b * hw


def phase_k4():
    import torch

    from causal_gen_tpu_torch.ops.dmol import sample_from_discretized_mix_logistic
    from causal_gen_tpu_torch.ops.dmol_sample import dmol_sample, plan

    dev = torch.device("cuda")
    shapes = [(BS, 32, 32), (3, 7, 13)]
    max_err, excluded = 0.0, 0
    for i, shape in enumerate(shapes):
        for t in (0.3, 1.0):
            l, u_mix, u = k4_inputs(*shape, device=dev, seed=SEED + 20 + i)
            got = dmol_sample(l, 10, t, u_mix=u_mix, u=u)
            ref = sample_from_discretized_mix_logistic(l, 10, t, u_mix=u_mix, u=u)
            torch.cuda.synchronize()
            n_ex, err = k4_compare(l, u_mix, t, got, ref)
            excluded += n_ex
            max_err = max(max_err, err)
    log("K4", f"injected uniforms: kernel == plain version (same pick, x and scale within "
              f"1e-5*(1+|ref|)) at {[(b, 100, h, w) for b, h, w in shapes]}, t 0.3 and 1; "
              f"{excluded} pixels within 1e-5 of a tie excluded; max abs err {max_err:.3e}")

    stats = k4_philox_stats(dev)
    if stats["max_abs_z"] > 5 or stats["ks"] > 0.005 or not stats["same_seed_repeats"] \
            or not stats["other_seed_differs"]:
        raise AssertionError(f"K4 Philox statistics off: {stats}")
    log("K4", f"Philox: {stats['pixels']} pixels, mixture frequencies within "
              f"{stats['max_abs_z']:.2f} sigma of softmax(logits), KS of channel 0 against "
              f"the logistic CDF {stats['ks']:.2e}; same seed identical, other seed differs")

    b, h, w = shapes[0]
    pix = b * h * w
    plans = {str(s_): plan(s_[0] * s_[1] * s_[2], s_[1] * s_[2])._asdict()
             for s_ in shapes + [(1, 1, 1), (256, 32, 32)]}
    for key, pl in plans.items():
        log("K4", f"plan {key}: {pl['tile']} pixels, {pl['threads']} threads, {pl['blocks']} "
                  f"blocks, {pl['shared_bytes']} B shared, straddles images {pl['straddles']}")
    t = k4_time(b, h, w, dev)
    bound_ms = max(t["bytes"] / HBM_BYTES_PER_S, 550 * pix / FP32_FLOPS_PER_S) * 1e3
    dense_bytes = 424 * pix
    bound_dense_ms = dense_bytes / HBM_BYTES_PER_S * 1e3
    log("K4", f"({b},100,{h},{w}), from device memory: Philox kernel {t['ms'] * 1e3:.2f} us (bound "
              f"{bound_ms * 1e3:.2f} us for the {t['bytes'] / pix:.1f} B a pixel these picks need; "
              f"{bound_dense_ms * 1e3:.2f} us for all 424 B), injected uniforms "
              f"{t['ms_injected'] * 1e3:.2f} us, plain version {t['plain_ms'] * 1e3:.2f} us; outputs "
              f"sha256 Philox {t['philox_sha256'][:16]} injected {t['injected_sha256'][:16]}")
    return {"max_abs_err": max_err, "excluded_pixels": excluded, "philox": stats, "ms": t["ms"],
            "ms_injected": t["ms_injected"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bytes": t["bytes"], "bound_ms_dense": bound_dense_ms, "bytes_dense": dense_bytes,
            "sha256": {"philox": t["philox_sha256"], "injected": t["injected_sha256"]},
            "plans": plans, "shape": [b, 100, h, w]}


def k4_time(b, h, w, dev, keys=("ms", "ms_injected", "plain_ms")):
    """K4 at (b, 100, h, w) from device memory (8 input sets, 105 MB of l,
    overflow the 50 MB L2), in Philox mode and with injected uniforms, beside
    its plain version (``keys`` picks the timed ones); the bytes the timed
    Philox runs' picks need (the graph replays each call with the seeds it
    was captured with, so these picks); and the SHA-256 of the kernel's x and
    scale on those sets in both modes, so that two trees' kernels can be held
    bit for bit against each other."""
    import hashlib
    import statistics as st

    import torch

    from causal_gen_tpu_torch.ops.dmol import sample_from_discretized_mix_logistic
    from causal_gen_tpu_torch.ops.dmol_sample import dmol_sample

    sets = [k4_inputs(b, h, w, device=dev, seed=SEED + 30 + i) for i in range(8)]

    def philox(i):
        return torch.Generator().manual_seed(SEED + i)

    fns = {"ms": [lambda l=l, i=i: dmol_sample(l, 10, 1.0, generator=philox(i))
                  for i, (l, _, _) in enumerate(sets)],
           "ms_injected": [lambda l=l, um=um, u=u: dmol_sample(l, 10, 1.0, u_mix=um, u=u)
                           for l, um, u in sets],
           "plain_ms": [lambda l=l, um=um, u=u: sample_from_discretized_mix_logistic(
               l, 10, 1.0, u_mix=um, u=u) for l, um, u in sets]}
    out = {key: cuda_time_ms(fns[key]) for key in keys}
    for mode, key in (("philox", "ms"), ("injected", "ms_injected")):
        digest = hashlib.sha256()
        for fn in fns[key]:
            for t in fn():
                digest.update(t.cpu().numpy().tobytes())
        out[f"{mode}_sha256"] = digest.hexdigest()
    # bytes: what these picks need; operations: ~550 a pixel with Philox's
    # integer work, 0.27 us at 67 TOP/s, so bytes bound it
    out["bytes"] = st.mean(k4_bytes(k4_picks(l, dmol_sample(l, 10, 1.0, generator=philox(i))[1],
                                             1.0)) for i, (l, _, _) in enumerate(sets))
    return out


# (B, C, b, H, W): every block shape of ukbb192 in order of resolution, then
# shapes whose C and b are not multiples of 16, whose batch leaves a block of
# several images short and whose weights do not fit beside a tile; and every
# block shape of ukbb64 (float32, the registry's dtype)
UKBB_K2_SHAPES = [(BS, 32, 8, 192, 192), (BS, 64, 16, 96, 96), (BS, 96, 24, 48, 48),
                  (BS, 128, 32, 24, 24), (BS, 160, 40, 12, 12), (BS, 192, 48, 6, 6),
                  (BS, 512, 128, 1, 1)]
K2_SHAPES = UKBB_K2_SHAPES + [(3, 8, 2, 7, 13), (2, 48, 12, 9, 11), (5, 24, 8, 2, 3),
                              (2, 512, 128, 5, 4)]
UKBB64_K2_SHAPES = [(BS, 32, 8, 64, 64), (BS, 64, 16, 32, 32), (BS, 128, 32, 16, 16),
                    (BS, 256, 64, 8, 8), (BS, 512, 128, 4, 4), (BS, 1024, 256, 1, 1)]
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores


def k2_inputs(b, c, cb, h, w, dtype, bias, device, seed=SEED):
    """NCHW x ~ N(0, 1) (b, c, h, w) and OIHW w1 (cb, c, 3, 3), w2 (c, cb, 3, 3)
    scaled by 1/sqrt(fan-in), biases ~ N(0, 0.1) or None, in ``dtype``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=g)
    w1 = torch.randn((cb, c, 3, 3), generator=g) / math.sqrt(9 * c)
    w2 = torch.randn((c, cb, 3, 3), generator=g) / math.sqrt(9 * cb)
    b1 = 0.1 * torch.randn((cb,), generator=g) if bias else None
    b2 = 0.1 * torch.randn((c,), generator=g) if bias else None
    return [None if t is None else t.to(device=device, dtype=dtype)
            for t in (x, w1, w2, b1, b2)]


def bf16_ulp(v):
    """One bf16 ulp at |v| (elementwise): 2^(floor(log2 |v|) - 7); 2^-133 at 0."""
    import torch

    return torch.exp2(torch.floor(torch.log2(v.abs().float().clamp(min=2.0 ** -126))) - 7)


def k2_compare(args, got, ref):
    """K2 against its plain version on the same inputs. float32: within 1e-5
    abs + rel. bf16: within one bf16 ulp of |y|, plus what one element of mid
    rounded the other way moves y by (max |w2| times one ulp of max |mid|):
    the two sum in another order in float32, and where a sum lands next to a
    bf16 rounding boundary, mid or y round to the neighbouring value. Returns
    (max abs err, elements that differ, elements beyond one ulp of |y|);
    raises on a mismatch."""
    import torch
    import torch.nn.functional as F

    x, w1, w2, b1, b2 = args
    diff = (got.float() - ref.float()).abs()
    if x.dtype == torch.float32:
        tol = 1e-5 + 1e-5 * ref.abs()
    else:
        mid = F.conv2d(F.relu(x).float(), w1.float(), None if b1 is None else b1.float(),
                       padding=1)
        tol = bf16_ulp(ref) + w2.float().abs().max() * bf16_ulp(mid.abs().max())
    bad = int((diff > tol).sum().item())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"K2 disagrees with its plain version at {tuple(x.shape)} "
                             f"{x.dtype}, bias {b1 is not None}: {bad} elements over the "
                             f"tolerance, max err {diff.max().item():.3e}")
    beyond_ulp = int((diff > bf16_ulp(ref)).sum().item()) if x.dtype != torch.float32 else 0
    return diff.max().item(), int((diff > 0).sum().item()), beyond_ulp


def k2_bound_ms(b, c, cb, h, w, itemsize):
    """The least time of the K2 call: x read and y written once (plus the
    weights), over the HBM rate; 36 C b flops a pixel over the peak of the
    storage type (bf16 tensor cores, or float32 on the CUDA cores). Returns
    (ms, bytes, flops, "bytes" or "operations", whichever binds)."""
    nbytes = (2 * b * c * h * w + 18 * c * cb + c + cb) * itemsize
    flops = 36 * c * cb * b * h * w
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3, nbytes, flops,
            "bytes" if t_bytes >= t_ops else "operations")


def cudnn_pair(x, w1, w2, b1, b2):
    """The light block as one PyTorch call a conv (cuDNN): K2's library yardstick."""
    import torch.nn.functional as F

    return x + F.conv2d(F.relu(F.conv2d(F.relu(x), w1, b1, padding=1)), w2, b2, padding=1)


def k2_time(b, c, cb, h, w, dtype, dev, seed=SEED + 60,
            keys=("ms", "plain_ms", "library_ms")):
    """K2's device time at one shape with biases, beside its plain version,
    the cuDNN conv pair and its bound (``keys`` picks the timed ones). Enough
    input sets (x, y and the weights) to fill 100 MB cycle through one CUDA
    graph, so every launch reads from device memory and not from the 50 MB L2."""
    import torch

    from causal_gen_tpu_torch.ops.fused_block import fused_light_block, fused_light_block_ref

    itemsize = torch.finfo(dtype).bits // 8
    set_bytes = (2 * b * c * h * w + 18 * c * cb) * itemsize
    n_sets = min(64, max(3, math.ceil(100e6 / set_bytes)))
    sets = [k2_inputs(b, c, cb, h, w, dtype, True, dev, seed=seed + i) for i in range(n_sets)]
    per_graph = max(6, n_sets)
    out = {"shape": [b, c, cb, h, w], "dtype": str(dtype)[6:], "input_sets": n_sets}
    fns = {"ms": fused_light_block, "plain_ms": fused_light_block_ref, "library_ms": cudnn_pair}
    for key in keys:
        out[key] = cuda_time_ms([lambda a=a, fn=fns[key]: fn(*a) for a in sets], reps=20,
                                per_graph=per_graph)
    out["bound_ms"], out["bytes"], out["flops"], out["bound_by"] = k2_bound_ms(
        b, c, cb, h, w, itemsize)
    return out


def tune_k2(top=8, per_cluster=2):
    """The fastest float32 K2 launch at every bs-32 block shape of ukbb64 and
    ukbb192, among the planner's ``top`` least estimates and its
    ``per_cluster`` least at each cluster size (ops/fused_block.py::
    f32_candidates), each checked against the plain version and timed as
    k2_time times (from device memory, with biases). Returns {shape: (th,
    tw, ni, kc, ng1, ng2, cs)}: ops/fused_block.py keeps it as F32_TUNED."""
    import torch

    from causal_gen_tpu_torch.ops import fused_block as k2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    table = {}
    for shape in UKBB64_K2_SHAPES + UKBB_K2_SHAPES:
        b, c, cb, h, w = shape
        cands = k2.f32_candidates(*shape)
        pick = [cfg for _, cfg in cands[:top]]
        for cs in k2.F32_CLUSTERS:
            pick += [cfg for _, cfg in cands if cfg[-1] == cs][:per_cluster]
        pick = list(dict.fromkeys(pick))
        n_sets = min(64, max(3, math.ceil(100e6 / ((2 * b * c * h * w + 18 * c * cb) * 4))))
        sets = [k2_inputs(*shape, torch.float32, True, dev, seed=SEED + 60 + i)
                for i in range(n_sets)]
        ref = k2.fused_light_block_ref(*sets[0])
        timed = []
        for cfg in pick:
            p = k2.f32_plan_of(*shape, cfg)
            got = k2.launch(*sets[0], p)
            torch.cuda.synchronize()
            k2_compare(sets[0], got, ref)
            timed.append((cuda_time_ms([lambda a=a, p=p: k2.launch(*a, p) for a in sets], reps=10,
                                       per_graph=max(6, n_sets)), cfg))
        timed.sort()
        table[shape] = timed[0][1]
        log("tune-k2", f"{shape}: fastest {timed[0][1]} {timed[0][0] * 1e3:.1f} us of "
                       f"{len(timed)}; the estimate's pick {pick[0]} "
                       f"{dict((c_, t) for t, c_ in timed)[pick[0]] * 1e3:.1f} us")
    print("F32_TUNED = " + repr(table), flush=True)
    return table


def k2_blocks_by_shape(cfg, vae):
    """{(C, b, res): [encoder blocks, decoder blocks]} that K2 covers in an
    HVAE: a DSCM.forward launches K2 2 x encoder + 4 x decoder times at each
    shape (bs BS), an HVAE.sample once a decoder block."""
    res_enc = []
    for i, st in enumerate(cfg.enc_stages):
        if i == 0 and st.n_blocks == 0 and st.down_rate is None:
            continue
        res_enc += [st.res] * (st.n_blocks + (st.down_rate is not None))
    out = {}
    for blk, res in [(b, r) for b, r in zip(vae.encoder._blocks, res_enc) if b.k2_covered] + \
            [(d.conv, d.resolution) for d in vae.decoder._blocks if d.conv.k2_covered]:
        cb, c = blk._convs[0].weight.shape[:2]
        out.setdefault((c, cb, res), [0, 0])[0 if blk in vae.encoder._blocks else 1] += 1
    return out


def k2_timed(shapes, dtype, by_shape, dev):
    """k2_time at each (B, C, b, H, W) of ``shapes`` with the launch plan and
    the launches a DSCM.forward (2 x encoder + 4 x decoder blocks) and an
    HVAE.sample (decoder blocks) of the model whose ``by_shape`` it is; and
    each time summed over those launches."""
    from causal_gen_tpu_torch.ops.fused_block import plan

    times, per = [], {k: {"forward": 0.0, "sample": 0.0} for k in
                      ("ms", "plain_ms", "library_ms", "bound_ms")}
    for b, c, cb, h, w in shapes:
        t = k2_time(b, c, cb, h, w, dtype, dev)
        enc, dec = by_shape[(c, cb, h)]
        t.update(plan=plan(b, c, cb, h, w, dtype)._asdict(),
                 launches_per_forward=2 * enc + 4 * dec, launches_per_sample=dec)
        times.append(t)
        for k in per:
            per[k]["forward"] += t["launches_per_forward"] * t[k]
            per[k]["sample"] += t["launches_per_sample"] * t[k]
        log("K2", f"({b},{c},{h},{w}) b={cb} {str(dtype)[6:]} with biases, from device memory, "
                  f"{t['launches_per_forward']} launches a forward: kernel {t['ms'] * 1e3:.2f} us "
                  f"(bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}), plain version "
                  f"{t['plain_ms'] * 1e3:.2f} us, cuDNN conv pair {t['library_ms'] * 1e3:.2f} us; "
                  f"plan {plan_text(t['plan'])}")
    return times, per


def plan_text(p):
    """One K2 plan in a few words."""
    text = (f"{p['kernel']} {p['th']}x{p['tw']} tile, {p['ni']} images, {p['threads']} threads, "
            f"{p['staging']}, {p['smem']} B")
    return text + (f", chunk {p['kc']}, NG {p['ng1']}/{p['ng2']}" if p["kernel"] == "simt" else "")


def phase_k2():
    """K2 against its plain version at every shape of K2_SHAPES in float32
    (the CUDA-core kernel, TF32 off) and bf16 (the tensor-core kernel), and
    at ukbb64's shapes in float32, with and without biases. Each kernel
    timed at every shape of its main path beside its bound, its plain
    version and the cuDNN conv pair (TF32 off), and summed over the launches
    of a DSCM.forward and an HVAE.sample: bf16 at ukbb192's shapes; float32
    at ukbb64's (its main path) and at ukbb192's (the float32 setting)."""
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.ops.fused_block import (fused_light_block, fused_light_block_ref,
                                                      plan)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    checks = []
    for i, (b, c, cb, h, w) in enumerate(K2_SHAPES + UKBB64_K2_SHAPES):
        dtypes = (torch.float32, torch.bfloat16) if i < len(K2_SHAPES) else (torch.float32,)
        for dtype in dtypes:
            for bias in (False, True):
                args = k2_inputs(b, c, cb, h, w, dtype, bias, dev, seed=SEED + 50 + i)
                got = fused_light_block(*args)
                ref = fused_light_block_ref(*args)
                torch.cuda.synchronize()
                err, n_diff, n_beyond = k2_compare(args, got, ref)
                checks.append({"shape": [b, c, cb, h, w], "dtype": str(dtype)[6:], "bias": bias,
                               "plan": plan(b, c, cb, h, w, dtype)._asdict(),
                               "max_abs_err": err, "n_differ": n_diff,
                               "n_beyond_one_ulp": n_beyond, "n": got.numel()})
    for dt, kernel, shapes in (("float32", "CUDA-core", K2_SHAPES + UKBB64_K2_SHAPES),
                               ("bfloat16", "tensor-core", K2_SHAPES)):
        cs = [ch for ch in checks if ch["dtype"] == dt]
        log("K2", f"{dt} ({kernel} kernel): == plain version at (B,C,b,H,W) {shapes}, with "
                  f"and without biases; max abs err {max(ch['max_abs_err'] for ch in cs):.3e}; "
                  f"elements that differ {sum(ch['n_differ'] for ch in cs)} of "
                  f"{sum(ch['n'] for ch in cs)}"
            + (f", beyond one ulp of |y| {sum(ch['n_beyond_one_ulp'] for ch in cs)}"
               if dt == "bfloat16" else ""))

    by_shape = k2_blocks_by_shape(ukbb_config(), HVAE(ukbb_config(), device="meta"))
    by_shape64 = k2_blocks_by_shape(ukbb64_config(), HVAE(ukbb64_config(), device="meta"))
    for name, got, want in (("UKBB_K2_SHAPES", by_shape, UKBB_K2_SHAPES),
                            ("UKBB64_K2_SHAPES", by_shape64, UKBB64_K2_SHAPES)):
        if sorted((BS, c, cb, r, r) for c, cb, r in got) != sorted(want):
            raise AssertionError(f"{name} {want} are not the model's K2 shapes {sorted(got)}")
    times, per = k2_timed(UKBB_K2_SHAPES, torch.bfloat16, by_shape, dev)
    f64_times, f64_per = k2_timed(UKBB64_K2_SHAPES, torch.float32, by_shape64, dev)
    f192_times, f192_per = k2_timed(UKBB_K2_SHAPES, torch.float32, by_shape, dev)
    for what, p in (("ukbb192 bf16", per), ("ukbb64 float32", f64_per),
                    ("ukbb192 float32", f192_per)):
        log("K2", f"summed over a {what} DSCM.forward's launches (bs 32): kernel "
                  f"{p['ms']['forward']:.3f} ms, cuDNN conv pair {p['library_ms']['forward']:.3f} "
                  f"ms, plain version {p['plain_ms']['forward']:.3f} ms, bound "
                  f"{p['bound_ms']['forward']:.3f} ms; an HVAE.sample's: kernel "
                  f"{p['ms']['sample']:.3f} ms, pair {p['library_ms']['sample']:.3f} ms, bound "
                  f"{p['bound_ms']['sample']:.3f} ms")
    hot, hot64 = times[0], max(f64_times, key=lambda t: t["launches_per_forward"])
    return {"checks": checks, "times": times, "per_path": per, "f32_times_ukbb64": f64_times,
            "f32_per_path_ukbb64": f64_per, "f32_times_ukbb192": f192_times,
            "f32_per_path_ukbb192": f192_per, "f32": hot64,
            "max_abs_err_bf16": max(ch["max_abs_err"] for ch in checks if ch["dtype"] != "float32"),
            "max_abs_err_f32": max(ch["max_abs_err"] for ch in checks if ch["dtype"] == "float32"),
            **{k: hot[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


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

        times = forward_times(dscm, obs, do, g)
        prof = profile_calls(lambda: dscm.forward(obs, do, generator=g), 3, "forward")
    ms = statistics.median(times)
    log("slice", f"DSCM.forward bs {BS}: median {ms:.3f} ms over 20 calls "
                 f"(min {min(times):.3f}, max {max(times):.3f}) = {BS / ms * 1e3:.1f} cf/s")
    return {"profile": prof, "launches": launches, "cf_x_err": cf_err, "rel_err": rel,
            "null_err": null_err, "forward_ms": ms, "forward_ms_all": times,
            "cf_per_s": BS / ms * 1e3}


def profile_calls(fn, calls: int = 3, unit: str = "forward"):
    """Device time by kernel over ``calls`` calls of ``fn`` under
    torch.profiler, and the device's busy share of the wall time of that
    window (the profiler's own host cost included)."""
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
    # the device's own events: a host op's device time is theirs; a user
    # annotation (AdamW's "Optimizer.step#AdamW.step") spans kernels counted already
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0 \
                and not getattr(evt, "is_user_annotation", False):
            kernels[evt.key] = (evt.self_device_time_total / calls, evt.count // calls)
    device_us = sum(t for t, _ in kernels.values())
    if device_us == 0:
        log("profile", "torch.profiler recorded no device time: busy share not measured")
        return {f"device_ms_per_{unit}": None}

    def us_of(*names):
        return sum(t for k, (t, _) in kernels.items() if any(n in k for n in names))

    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    out = {f"wall_ms_per_{unit}": wall_us / calls / 1e3,
           f"device_ms_per_{unit}": device_us / 1e3,
           "device_busy_share": device_us * calls / wall_us,
           f"kernel_launches_per_{unit}": sum(c for _, c in kernels.values()),
           f"k1_device_ms_per_{unit}": us_of("sample_kl_kernel") / 1e3,
           f"k1_bwd_device_ms_per_{unit}": us_of("sample_kl_backward") / 1e3,
           f"k3_device_ms_per_{unit}": us_of("dmol_forward") / 1e3,
           f"k3_bwd_device_ms_per_{unit}": us_of("dmol_backward") / 1e3,
           f"k4_device_ms_per_{unit}": us_of("dmol_sample_kernel") / 1e3,
           f"k2_device_ms_per_{unit}": us_of("fused_light_block_kernel") / 1e3,
           "top": [(k[:80], t / 1e3, c) for k, (t, c) in top]}
    log("profile", f"per {unit} under the profiler: wall {out[f'wall_ms_per_{unit}']:.2f} ms, "
                   f"device busy {out[f'device_ms_per_{unit}']:.2f} ms "
                   f"({out['device_busy_share']:.1%}), {out[f'kernel_launches_per_{unit}']} "
                   f"device kernels and copies; K1 "
                   f"{out[f'k1_device_ms_per_{unit}'] * 1e3:.1f} us, K1-bwd "
                   f"{out[f'k1_bwd_device_ms_per_{unit}'] * 1e3:.1f} us, K3 "
                   f"{out[f'k3_device_ms_per_{unit}'] * 1e3:.1f} us, K3-bwd "
                   f"{out[f'k3_bwd_device_ms_per_{unit}'] * 1e3:.1f} us, K4 "
                   f"{out[f'k4_device_ms_per_{unit}'] * 1e3:.1f} us, K2 "
                   f"{out[f'k2_device_ms_per_{unit}'] * 1e3:.1f} us "
                   f"({out[f'k2_device_ms_per_{unit}'] * 1e3 / device_us:.1%} of device time)")
    for k, t, c in out["top"]:
        log("profile", f"  {t * 1e3:9.1f} us  x{c:<5d} {k}")
    return out


def _sample_noise(cfg, rng, head):
    """Injected draws for HVAE.sample(return_loc=False) at bs BS: a standard
    normal per stochastic block, then the head's draw (a normal of the image's
    shape, or the DMoL uniforms (u_mix, u)), as CPU tensors."""
    import torch

    from causal_gen_tpu_torch.ops.dmol import UNIFORM_HI, UNIFORM_LO

    res, n = cfg.input_res, BS
    prior = [torch.from_numpy(rng.standard_normal((n, cfg.z_dim, r, r)).astype("float32"))
             for r in k1_res(cfg)]
    if head == "dmol":
        draw = tuple(torch.from_numpy(rng.uniform(UNIFORM_LO, UNIFORM_HI, (n, c, res, res))
                                      .astype("float32")) for c in (10, 3))
    else:
        draw = torch.from_numpy(rng.standard_normal((n, cfg.input_channels, res, res))
                                .astype("float32"))
    return prior, draw


def _to(d, dev):
    return tuple(t.to(dev) for t in d) if isinstance(d, tuple) else d.to(dev)


def phase_sample(morpho_cfg):
    """Sampling on the card: F1 (a CPU generator on CUDA), the cmnist +
    diag_dmol HVAE.sample main path, card against CPU, its time, and
    DSCM.forward with t_abduct."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED + 40)
    rng = np.random.default_rng(SEED + 41)
    out = {}
    with torch.inference_mode():
        # F1: the prior draws take a CPU generator on the card
        mvae = HVAE(morpho_cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
        pa_m = torch.from_numpy(synth_parents(morpho_cfg, rng, BS)).to(dev)
        loc, scale = mvae.sample(pa_m, return_loc=True, t=0.5, generator=g)
        n_sto = len(k1_res(morpho_cfg))
        fl_loc, fl_scale = mvae.forward_latents([None] * n_sto, pa_m, generator=g)
        torch.cuda.synchronize()
        for a in (loc, scale, fl_loc, fl_scale):
            if a.shape != (BS, 1, 32, 32) or a.device.type != dev.type or not torch.isfinite(a).all():
                raise AssertionError("F1: sample or forward_latents with a CPU generator is "
                                     "malformed on the card")
        log("sample", f"F1: morphomnist HVAE.sample(return_loc=True, t=0.5) and "
                      f"forward_latents([None] * {n_sto}) with a CPU generator ran on the card")

        # the main path: counts set to 0 just before, read just after
        cfg = train_config("cmnist_dmol")
        vae = HVAE(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
        pa = torch.from_numpy(synth_parents(cfg, rng, BS)).to(dev)
        reset_counts()
        x, s = vae.sample(pa, return_loc=False, t=0.7, generator=g)
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict({k: 0 for k in counts}, dmol_sample=1)
        if counts != want:
            raise AssertionError(f"HVAE.sample cmnist diag_dmol: launches {counts}, expected {want}")
        if x.shape != (BS, 3, 32, 32) or not torch.isfinite(x).all() or x.abs().max() > 1 \
                or not torch.isfinite(s).all() or not (s > 0).all():
            raise AssertionError("HVAE.sample cmnist diag_dmol: x or scale is malformed")
        out["launches"] = counts
        log("sample", f"main path HVAE.sample(return_loc=False, t=0.7) cmnist diag_dmol bs {BS}: "
                      f"launches {counts}; x finite in [{x.min().item():.3f}, "
                      f"{x.max().item():.3f}]")

        # card against the CPU plain path, same weights and draws
        out["card_vs_cpu"] = {}
        for name, mcfg, gpu_model, head in (("morphomnist", morpho_cfg, mvae, "dgauss"),
                                            ("cmnist diag_dmol", cfg, vae, "dmol")):
            cpu_model = HVAE(mcfg, device="cpu")
            cpu_model.load_state_dict({k: v.cpu() for k, v in gpu_model.state_dict().items()})
            pa_c = torch.from_numpy(synth_parents(mcfg, rng, BS))
            prior, draw = _sample_noise(mcfg, rng, head)
            for return_loc in (True, False):
                noise = prior + ([] if return_loc else [draw])
                got = gpu_model.sample(pa_c.to(dev), return_loc, 0.7,
                                       noise=iter([_to(e, dev) for e in noise]))
                ref = cpu_model.sample(pa_c, return_loc, 0.7, noise=iter(noise))
                clear = torch.ones((BS, mcfg.input_res, mcfg.input_res), dtype=torch.bool)
                if head == "dmol" and not return_loc:
                    # the pick turns on the last bits of a perturbed logit only
                    # within ~1e-6 of a tie; l on the card and on the CPU
                    # differ by conv rounding, so pixels within 1e-4 are left out
                    h, _ = cpu_model.decoder(pa_c, noise=iter(prior), t=0.7)
                    clear = k4_clear(cpu_model.likelihood.conv(h), draw[0], 1e-4)
                err = max((a.cpu() - b).abs()[clear[:, None].expand_as(b)].max().item()
                          for a, b in zip(got, ref))
                key = f"{name} return_loc={return_loc}"
                out["card_vs_cpu"][key] = {"max_abs_err": err,
                                           "excluded_pixels": int((~clear).sum().item())}
                if err > 1e-4:
                    raise AssertionError(f"HVAE.sample {key}: card vs CPU max err {err:.3e}")
        log("sample", "card == CPU plain path (TF32 off, draws injected), t 0.7: " + "; ".join(
            f"{k} max abs err {v['max_abs_err']:.3e} ({v['excluded_pixels']} pixels within "
            f"1e-4 of a tie left out)" for k, v in out["card_vs_cpu"].items()))

        for _ in range(3):
            vae.sample(pa, return_loc=False, t=0.7, generator=g)
        times = []
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vae.sample(pa, return_loc=False, t=0.7, generator=g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        # the same with every draw made beforehand on the card: what the
        # host's normals and their copies cost a call
        prior, draw = _sample_noise(cfg, rng, "dmol")
        noise = [_to(e, dev) for e in prior + [draw]]
        times_inj = []
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vae.sample(pa, return_loc=False, t=0.7, noise=iter(noise))
            torch.cuda.synchronize()
            times_inj.append((time.perf_counter() - t0) * 1e3)
        ms_inj = statistics.median(times_inj)
        out.update({"sample_ms": ms, "sample_ms_all": times, "images_per_s": BS / ms * 1e3,
                    "sample_ms_draws_on_card": ms_inj, "sample_ms_draws_on_card_all": times_inj})
        log("sample", f"HVAE.sample(return_loc=False, t=0.7) cmnist diag_dmol bs {BS}: median "
                      f"{ms:.3f} ms over 15 calls (min {min(times):.3f}, max {max(times):.3f}) = "
                      f"{BS / ms * 1e3:.1f} images/s; with the draws made beforehand on the card "
                      f"{ms_inj:.3f} ms (min {min(times_inj):.3f}, max {max(times_inj):.3f})")
        out["profile"] = profile_calls(lambda: vae.sample(pa, return_loc=False, t=0.7,
                                                          generator=g), 3, "sample")

        # DSCM.forward with the abduction at t = 0.1: card against CPU
        dscm = build_slice(morpho_cfg, "cuda")
        obs = synth_obs(morpho_cfg, dev)
        do = {"thickness": torch.full((BS, 1), 0.5, device=dev)}
        noise = [rng.standard_normal((BS, morpho_cfg.z_dim, r, r)).astype(np.float32)
                 for r in k1_res(morpho_cfg) * 2]
        gpu = dscm.forward(obs, do, noise=[torch.from_numpy(e).to(dev) for e in noise],
                           t_abduct=0.1)
        cpu_dscm = build_slice(morpho_cfg, "cpu", state=[
            {k: v.cpu() for k, v in m.state_dict().items()}
            for m in (dscm.vae, dscm.pgm, dscm.predictor)])
        cpu = cpu_dscm.forward({k: v.cpu() for k, v in obs.items()},
                               {k: v.cpu() for k, v in do.items()},
                               noise=[torch.from_numpy(e) for e in noise], t_abduct=0.1)
        cf_err = (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs().max().item()
        if cf_err > 1e-4:
            raise AssertionError(f"DSCM.forward(t_abduct=0.1): card vs CPU cf_x err {cf_err:.3e}")
        out["dscm_t_abduct_cf_x_err"] = cf_err
        log("sample", f"DSCM.forward do(thickness) t_abduct=0.1 bs {BS}: card == CPU plain path, "
                      f"cf_x max abs err {cf_err:.3e}")
    return out


UKBB_VARS = ("sex", "mri_seq", "age", "brain_volume", "ventricle_volume")
UKBB_DO = "ventricle_volume"  # do(ventricle_volume = 0.5)
CHECK_BS = 2  # batch of the card-vs-CPU checks at full ukbb192 width


def ukbb_config(dtype="bfloat16", bs=BS):
    """The registry's ukbb192 (z_max_res 192: all 40 decoder blocks are
    stochastic), at its widths and depth."""
    from causal_gen_tpu_torch.config import get_config

    return get_config("ukbb192", bs=bs, dtype=dtype)


def ukbb64_config(bs=BS):
    """The registry's ukbb64 at its widths and depth, in its float32."""
    from causal_gen_tpu_torch.config import get_config

    return get_config("ukbb64", bs=bs)


def k2_cover(vae):
    """(encoder blocks, decoder blocks) of an HVAE that K2 covers."""
    return (sum(b.k2_covered for b in vae.encoder._blocks),
            sum(b.conv.k2_covered for b in vae.decoder._blocks))


def ukbb_bounds_per_forward(cfg, vae):
    """The least device time of K2's 2 x encoder + 4 x decoder launches and of
    K1's 2 x stochastic-block launches in one DSCM.forward at bs BS
    (k2_bound_ms at each covered block's shape in bf16; K1 28 B an element),
    of K2's decoder launches in one HVAE.sample, and of K1's and K1-bwd's
    launches in one train step (28 and 40 B an element)."""
    by_shape = k2_blocks_by_shape(cfg, vae)
    bound = {k: k2_bound_ms(BS, k[0], k[1], k[2], k[2], 2)[0] for k in by_shape}
    elems = sum(BS * cfg.z_dim * r * r for r in k1_res(cfg))
    return {"k2_bound_ms_per_forward": sum((2 * e + 4 * d) * bound[k]
                                           for k, (e, d) in by_shape.items()),
            "k2_bound_ms_per_sample": sum(d * bound[k] for k, (_, d) in by_shape.items()),
            "k1_bound_ms_per_forward": 2 * 28 * elems / HBM_BYTES_PER_S * 1e3,
            "k1_bound_ms_per_step": 28 * elems / HBM_BYTES_PER_S * 1e3,
            "k1_bwd_bound_ms_per_step": 40 * elems / HBM_BYTES_PER_S * 1e3}


def build_ukbb(cfg, device, state=None):
    """A UK Biobank DSCM (ukbb192 or ukbb64): the HVAE, the UKBB FlowPGM as PGM and as predictor
    (cli/train_cf.py builds it so), weights from the seed or ``state``."""
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.pgm.dscm import DSCM
    from causal_gen_tpu_torch.pgm.flow_pgm import FlowPGM

    g = torch.Generator().manual_seed(SEED)
    vae = HVAE(cfg, device=device, generator=g)
    pgm = FlowPGM(setup_predictors=False, device=device, generator=g)
    pred = FlowPGM(setup_predictors=True, input_res=cfg.input_res, device=device, generator=g)
    if state is not None:
        for mod, sd in zip((vae, pgm, pred), state):
            mod.load_state_dict(sd)
    return DSCM(cfg, pgm, pred, vae)


def ukbb_obs(cfg, n, device, seed=SEED):
    """A batch in the PGM's space: x in [-1, 1], sex and mri_seq 0/1, age and
    the volumes in [-0.8, 0.8]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    res = cfg.input_res
    obs = {"x": rng.uniform(-1, 1, (n, 1, res, res))}
    for k in UKBB_VARS:
        obs[k] = rng.integers(0, 2, (n, 1)) if k in ("sex", "mri_seq") else \
            rng.uniform(-0.8, 0.8, (n, 1))
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in obs.items()}


def ukbb_transfer_bound(dscm, obs, out, noise, eps=2.0 ** -4):
    """Per-pixel bound on a bf16 cf_x against another bf16 run: decoded locs
    within eps and scales within eps relative, through cf_x = cf_loc +
    cf_scale u, u = (x - rec_loc) / rec_scale (tests/test_torch_ukbb_dscm.py),
    from ``dscm``'s own decodes of ``obs`` with the abduction's ``noise``."""
    from causal_gen_tpu_torch.pgm.dscm import vae_preprocess

    cfg, vae = dscm.cfg, dscm.vae
    pa = {k: v for k, v in obs.items() if k != "x"}
    cf_pa = {k: v for k, v in out["cfs"].items() if k != "x"}
    zs = vae.abduct(obs["x"], vae_preprocess(cfg, pa), noise=iter(noise))
    rec_loc, rec_scale = vae.forward_latents(zs, vae_preprocess(cfg, pa))
    _, cf_scale = vae.forward_latents(zs, vae_preprocess(cfg, cf_pa))
    u = (obs["x"] - rec_loc) / rec_scale
    return eps * (1 + 2 * (cf_scale * u).abs() + cf_scale / rec_scale)


def phase_ukbb_slice():
    """DSCM.forward on ukbb192 in bf16 at bs BS: the main path with K2's and
    K1's launch counts against the config's, card against the CPU plain path
    at bs CHECK_BS in float32 and in bf16, the time of a forward and the
    profiler."""
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ukbb_config()
    dscm = build_ukbb(cfg, "cuda")
    enc_k2, dec_k2 = k2_cover(dscm.vae)
    n_sto = len(k1_res(cfg))
    obs = ukbb_obs(cfg, BS, dev)
    do = {UKBB_DO: torch.full((BS, 1), 0.5, device=dev)}
    g = torch.Generator().manual_seed(SEED + 70)
    out = {"config": "ukbb192 (registry: z_max_res 192, bias_max_res 64), bf16",
           "k2_blocks": {"encoder": enc_k2, "decoder": dec_k2},
           **ukbb_bounds_per_forward(cfg, dscm.vae)}
    with torch.inference_mode():
        # the main path: counts set to 0 just before, read just after
        reset_counts()
        res = dscm.forward(obs, do, generator=g)
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict({k: 0 for k in counts}, fused_light_block=2 * enc_k2 + 4 * dec_k2,
                    fused_light_block_tc=2 * enc_k2 + 4 * dec_k2, fused_sample_kl=2 * n_sto)
        if counts != want:
            raise AssertionError(f"ukbb192 DSCM.forward: launches {counts}, expected {want}")
        cf_x = res["cfs"]["x"]
        if cf_x.shape != obs["x"].shape or cf_x.dtype != torch.float32 \
                or not torch.isfinite(cf_x).all() or cf_x.abs().max() > 1 \
                or not all(torch.isfinite(res[k]) for k in ("elbo", "nll", "kl", "aux_loss",
                                                              "loss")):
            raise AssertionError("ukbb192 main path: cf_x or a loss term is malformed")
        out["launches"] = counts
        log("ukbb", f"main path {out['config']} DSCM.forward do({UKBB_DO}) bs {BS}: launches "
                    f"{counts} (K2 covers {enc_k2} encoder and {dec_k2} decoder blocks: 2 x "
                    f"{enc_k2} + 4 x {dec_k2}; K1 2 x {n_sto}); elbo {res['elbo'].item():.5f}")

        # card against the CPU plain path: same weights, batch and noise
        out["card_vs_cpu"] = {}
        state = [{k: v.cpu() for k, v in m.state_dict().items()}
                 for m in (dscm.vae, dscm.pgm, dscm.predictor)]
        obs_c = ukbb_obs(cfg, CHECK_BS, torch.device("cpu"), seed=SEED + 71)
        do_c = {UKBB_DO: torch.full((CHECK_BS, 1), 0.5)}
        rng = np.random.default_rng(SEED + 72)
        noise = [torch.from_numpy(rng.standard_normal((CHECK_BS, cfg.z_dim, r, r))
                                  .astype(np.float32)) for r in k1_res(cfg) * 2]
        for dtype in ("float32", "bfloat16"):
            c = ukbb_config(dtype, CHECK_BS)
            gpu_d, cpu_d = build_ukbb(c, "cuda", state), build_ukbb(c, "cpu", state)
            reset_counts()  # float32 runs K2's SIMT kernel: its launches are counted here
            gpu = gpu_d.forward({k: v.to(dev) for k, v in obs_c.items()},
                                {k: v.to(dev) for k, v in do_c.items()},
                                noise=[e.to(dev) for e in noise])
            torch.cuda.synchronize()
            counts_c = read_counts()
            cpu = cpu_d.forward(obs_c, do_c, noise=noise)
            err = (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs()
            rel = {k: abs(gpu[k].item() - cpu[k].item()) / abs(cpu[k].item())
                   for k in ("elbo", "nll", "kl", "aux_loss", "loss")}
            entry = {"cf_x_max_abs_err": err.max().item(), "rel_err": rel, "launches": counts_c}
            kernel = "fused_light_block_simt" if dtype == "float32" else "fused_light_block_tc"
            if counts_c[kernel] != 2 * enc_k2 + 4 * dec_k2 or \
                    counts_c["fused_light_block"] != counts_c[kernel]:
                raise AssertionError(f"ukbb192 {dtype} DSCM.forward bs {CHECK_BS}: launches "
                                     f"{counts_c}, expected {2 * enc_k2 + 4 * dec_k2} of {kernel}")
            if dtype == "float32":
                ok = err.max().item() <= 1e-4 and max(rel.values()) <= 1e-4
                what = "cf_x within 1e-4 abs, every term within 1e-4 rel"
            else:
                bound = ukbb_transfer_bound(cpu_d, obs_c, cpu, noise[n_sto:])
                entry["cf_x_err_over_bound"] = (err / bound).max().item()
                ok = entry["cf_x_err_over_bound"] <= 1 and \
                    max(rel[k] for k in ("elbo", "nll", "kl")) <= 2e-2 and \
                    max(rel[k] for k in ("aux_loss", "loss")) <= 2.0 ** -4
                what = ("cf_x within the transfer's bound (eps 2^-4), elbo/nll/kl within 2e-2 "
                        "rel, aux_loss/loss within 2^-4 rel")
            out["card_vs_cpu"][dtype] = entry
            if not ok:
                raise AssertionError(f"ukbb192 DSCM.forward {dtype} card vs CPU: {entry}")
            log("ukbb", f"{dtype} bs {CHECK_BS}: card == CPU plain path ({what}): cf_x max abs "
                        f"err {err.max().item():.3e}"
                + (f" ({entry['cf_x_err_over_bound']:.3f} of the bound)" if dtype != "float32"
                   else "") + "; " + ", ".join(f"{k} rel {v:.2e}" for k, v in rel.items()))
            del gpu_d, cpu_d

        times = forward_times(dscm, obs, do, g)
        out["profile"] = profile_calls(lambda: dscm.forward(obs, do, generator=g), 3, "forward")
    ms = statistics.median(times)
    out.update({"forward_ms": ms, "forward_ms_all": times, "cf_per_s": BS / ms * 1e3,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    log("ukbb", f"ukbb192 bf16 DSCM.forward bs {BS}: median {ms:.3f} ms over 20 calls (min "
                f"{min(times):.3f}, max {max(times):.3f}) = {BS / ms * 1e3:.1f} cf/s; bounds "
                f"a forward: K2 {out['k2_bound_ms_per_forward']:.3f} ms, K1 "
                f"{out['k1_bound_ms_per_forward']:.3f} ms; K2 a sample "
                f"{out['k2_bound_ms_per_sample']:.3f} ms; a train step: K1 "
                f"{out['k1_bound_ms_per_step']:.3f} ms, K1-bwd "
                f"{out['k1_bwd_bound_ms_per_step']:.3f} ms")
    reset_counts()
    return out


def phase_ukbb_sample():
    """HVAE.sample(return_loc=False, t=0.7) on ukbb192 in bf16 at bs BS: K2 on
    every covered decoder block, card against CPU (float32, bs CHECK_BS,
    draws injected), its time."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ukbb_config()
    vae = HVAE(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    _, dec_k2 = k2_cover(vae)
    g = torch.Generator().manual_seed(SEED + 80)
    rng = np.random.default_rng(SEED + 81)
    pa = torch.from_numpy(synth_parents(cfg, rng, BS)).to(dev)
    out = {}
    with torch.inference_mode():
        reset_counts()
        x, s = vae.sample(pa, return_loc=False, t=0.7, generator=g)
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict({k: 0 for k in counts}, fused_light_block=dec_k2, fused_light_block_tc=dec_k2)
        if counts != want:
            raise AssertionError(f"ukbb192 HVAE.sample: launches {counts}, expected {want}")
        res = cfg.input_res
        if x.shape != (BS, 1, res, res) or not torch.isfinite(x).all() or x.abs().max() > 1 \
                or not torch.isfinite(s).all():
            raise AssertionError("ukbb192 HVAE.sample: x or scale is malformed")
        out["launches"] = counts
        log("ukbb-sample", f"main path HVAE.sample(return_loc=False, t=0.7) ukbb192 bf16 bs "
                           f"{BS}: launches {counts}")

        c = ukbb_config("float32", CHECK_BS)
        gpu_m = HVAE(c, device="cuda")
        gpu_m.load_state_dict(vae.state_dict())
        cpu_m = HVAE(c, device="cpu")
        cpu_m.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})
        pa_c = torch.from_numpy(synth_parents(c, rng, CHECK_BS))
        noise = [torch.from_numpy(rng.standard_normal((CHECK_BS, c.z_dim, r, r))
                                  .astype(np.float32)) for r in k1_res(c)]
        noise.append(torch.from_numpy(rng.standard_normal((CHECK_BS, 1, res, res))
                                      .astype(np.float32)))
        reset_counts()
        got = gpu_m.sample(pa_c.to(dev), False, 0.7, noise=iter([e.to(dev) for e in noise]))
        torch.cuda.synchronize()
        out["launches_f32_check"] = read_counts()
        if out["launches_f32_check"]["fused_light_block_simt"] != dec_k2:
            raise AssertionError(f"ukbb192 HVAE.sample float32: launches "
                                 f"{out['launches_f32_check']}, expected {dec_k2} of the SIMT K2")
        ref = cpu_m.sample(pa_c, False, 0.7, noise=iter(noise))
        err = max((a.cpu() - b).abs().max().item() for a, b in zip(got, ref))
        if err > 1e-4:
            raise AssertionError(f"ukbb192 HVAE.sample float32: card vs CPU max err {err:.3e}")
        out["card_vs_cpu_max_abs_err"] = err
        log("ukbb-sample", f"float32 bs {CHECK_BS}: card == CPU plain path (TF32 off, draws "
                           f"injected), x and scale max abs err {err:.3e}")
        del gpu_m, cpu_m

        for _ in range(3):
            vae.sample(pa, return_loc=False, t=0.7, generator=g)
        times = []
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vae.sample(pa, return_loc=False, t=0.7, generator=g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["profile"] = profile_calls(lambda: vae.sample(pa, return_loc=False, t=0.7,
                                                          generator=g), 3, "sample")
    ms = statistics.median(times)
    out.update({"sample_ms": ms, "sample_ms_all": times, "images_per_s": BS / ms * 1e3})
    log("ukbb-sample", f"ukbb192 bf16 HVAE.sample bs {BS}: median {ms:.3f} ms over 15 calls (min "
                       f"{min(times):.3f}, max {max(times):.3f}) = {BS / ms * 1e3:.1f} images/s")
    return out


def phase_ukbb_train():
    """The ukbb192 train step in bf16 at bs BS: no K2 (autograd records), the
    first step's metrics card against CPU in float32 at bs CHECK_BS, the time
    of a step."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import to_device, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 90)
    c = ukbb_config("float32", CHECK_BS)
    cpu_m = HVAE(c, device="cpu", generator=torch.Generator().manual_seed(SEED))
    gpu_m = HVAE(c, device="cuda")
    gpu_m.load_state_dict(cpu_m.state_dict())
    batch = synth_batch(c, rng)
    noise = [rng.standard_normal((CHECK_BS, c.z_dim, r, r)).astype(np.float32)
             for r in k1_res(c)]
    ms = {}
    for d, m in (("cpu", cpu_m), ("cuda", gpu_m)):
        dv = torch.device(d)
        out_d = train_step(c, init_train_state(c, m), to_device(batch, dv),
                           noise=[[torch.from_numpy(e).to(dv) for e in noise]])
        ms[d] = {k: float(v) for k, v in out_d.items()}
    rel = {k: abs(ms["cuda"][k] - ms["cpu"][k]) / abs(ms["cpu"][k])
           for k in ("elbo", "nll", "kl", "grad_norm")}
    if max(rel.values()) > 1e-4 or ms["cuda"]["skipped"] != ms["cpu"]["skipped"]:
        raise AssertionError(f"ukbb192 train step float32 card vs CPU: {ms}")
    log("ukbb-train", f"float32 bs {CHECK_BS}: first step card == CPU plain path (TF32 off): "
                      + ", ".join(f"{k} rel {v:.2e}" for k, v in rel.items()))
    del cpu_m, gpu_m

    cfg = ukbb_config()
    st = init_train_state(cfg, HVAE(cfg, device="cuda",
                                    generator=torch.Generator().manual_seed(SEED)))
    b = to_device(synth_batch(cfg, rng), dev)
    gen = torch.Generator().manual_seed(SEED + 91)
    reset_counts()
    m = train_step(cfg, st, b, generator=gen)
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected_counts(cfg, 1)
    if counts != want or not math.isfinite(float(m["elbo"])):
        raise AssertionError(f"ukbb192 train step: launches {counts}, expected {want}; {m}")
    log("ukbb-train", f"ukbb192 bf16 train step bs {BS}: launches {counts}; elbo "
                      f"{float(m['elbo']):.4f}, grad_norm {float(m['grad_norm']):.2f}")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        train_step(cfg, st, b, generator=gen)
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(cfg, st, b, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    out = {"rel_err": rel, "launches": counts, "step_ms": med, "step_ms_all": times,
           "images_per_s": BS / med * 1e3, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("ukbb-train", f"ukbb192 bf16 train step bs {BS}: median {med:.3f} ms over 10 (min "
                      f"{min(times):.3f}, max {max(times):.3f}) = {BS / med * 1e3:.1f} images/s; "
                      f"peak memory {out['peak_mem_gb']:.1f} GB")
    out["profile"] = profile_calls(lambda: train_step(cfg, st, b, generator=gen), 2, "step")
    return out


UKBB64_K2_LAUNCHES = (362, 60)  # K2's launches a ukbb64 DSCM.forward and HVAE.sample


def phase_ukbb64():
    """DSCM.forward do(ventricle_volume) on the registry's ukbb64, float32, at
    full width and depth, bs BS, under inference_mode: the main path with
    K2's and K1's launch counts against the config's (every covered block
    takes K2's float32 kernel), card against the CPU plain path at bs
    CHECK_BS with the noise injected (1e-4, TF32 off), the time of a forward
    and the profiler."""
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ukbb64_config()
    dscm = build_ukbb(cfg, "cuda")
    enc_k2, dec_k2 = k2_cover(dscm.vae)
    n_k2 = 2 * enc_k2 + 4 * dec_k2
    if (n_k2, dec_k2) != UKBB64_K2_LAUNCHES:
        raise AssertionError(f"ukbb64: K2 covers {enc_k2} encoder and {dec_k2} decoder blocks, "
                             f"not the {UKBB64_K2_LAUNCHES} launches a forward and a sample")
    n_sto = len(k1_res(cfg))
    obs = ukbb_obs(cfg, BS, dev)
    do = {UKBB_DO: torch.full((BS, 1), 0.5, device=dev)}
    g = torch.Generator().manual_seed(SEED + 100)
    out = {"config": "ukbb64 (registry), float32",
           "k2_blocks": {"encoder": enc_k2, "decoder": dec_k2}}
    with torch.inference_mode():
        # the main path: counts set to 0 just before, read just after
        reset_counts()
        res = dscm.forward(obs, do, generator=g)
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict({k: 0 for k in counts}, fused_light_block=n_k2, fused_light_block_simt=n_k2,
                    fused_sample_kl=2 * n_sto)
        if counts != want:
            raise AssertionError(f"ukbb64 DSCM.forward: launches {counts}, expected {want}")
        cf_x = res["cfs"]["x"]
        if cf_x.shape != obs["x"].shape or cf_x.dtype != torch.float32 \
                or not torch.isfinite(cf_x).all() or cf_x.abs().max() > 1 \
                or not all(torch.isfinite(res[k]) for k in ("elbo", "nll", "kl", "aux_loss",
                                                              "loss")):
            raise AssertionError("ukbb64 main path: cf_x or a loss term is malformed")
        out["launches"] = counts
        log("ukbb64", f"main path {out['config']} DSCM.forward do({UKBB_DO}) bs {BS}: launches "
                      f"{counts} (K2's float32 kernel on {enc_k2} encoder and {dec_k2} decoder "
                      f"blocks: 2 x {enc_k2} + 4 x {dec_k2}; K1 2 x {n_sto}); elbo "
                      f"{res['elbo'].item():.5f}")

        # card against the CPU plain path: same weights, batch and noise
        state = [{k: v.cpu() for k, v in m.state_dict().items()}
                 for m in (dscm.vae, dscm.pgm, dscm.predictor)]
        c = ukbb64_config(CHECK_BS)
        gpu_d, cpu_d = build_ukbb(c, "cuda", state), build_ukbb(c, "cpu", state)
        obs_c = ukbb_obs(c, CHECK_BS, torch.device("cpu"), seed=SEED + 101)
        do_c = {UKBB_DO: torch.full((CHECK_BS, 1), 0.5)}
        rng = np.random.default_rng(SEED + 102)
        noise = [torch.from_numpy(rng.standard_normal((CHECK_BS, c.z_dim, r, r))
                                  .astype(np.float32)) for r in k1_res(c) * 2]
        reset_counts()
        gpu = gpu_d.forward({k: v.to(dev) for k, v in obs_c.items()},
                            {k: v.to(dev) for k, v in do_c.items()},
                            noise=[e.to(dev) for e in noise])
        torch.cuda.synchronize()
        counts_c = read_counts()
        cpu = cpu_d.forward(obs_c, do_c, noise=noise)
        err = (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs().max().item()
        rel = {k: abs(gpu[k].item() - cpu[k].item()) / abs(cpu[k].item())
               for k in ("elbo", "nll", "kl", "aux_loss", "loss")}
        out["card_vs_cpu"] = {"cf_x_max_abs_err": err, "rel_err": rel, "launches": counts_c}
        if counts_c["fused_light_block_simt"] != n_k2 or err > 1e-4 or max(rel.values()) > 1e-4:
            raise AssertionError(f"ukbb64 DSCM.forward float32 bs {CHECK_BS} card vs CPU: "
                                 f"{out['card_vs_cpu']}")
        log("ukbb64", f"bs {CHECK_BS}: card == CPU plain path (TF32 off, noise injected; cf_x "
                      f"within 1e-4 abs, every term within 1e-4 rel): cf_x max abs err {err:.3e}; "
                      + ", ".join(f"{k} rel {v:.2e}" for k, v in rel.items()))
        del gpu_d, cpu_d

        times = forward_times(dscm, obs, do, g)
        out["profile"] = profile_calls(lambda: dscm.forward(obs, do, generator=g), 3, "forward")
    ms = statistics.median(times)
    out.update({"forward_ms": ms, "forward_ms_all": times, "cf_per_s": BS / ms * 1e3})
    log("ukbb64", f"ukbb64 float32 DSCM.forward bs {BS}: median {ms:.3f} ms over 20 calls (min "
                  f"{min(times):.3f}, max {max(times):.3f}) = {BS / ms * 1e3:.1f} cf/s")
    reset_counts()
    return out


MIMIC_VARS = ("sex", "age", "race", "finding")
# where the mimic192 flagship (checkpoints/mimic192_flagship/vae/hparams.json)
# departs from the registry's mimic192 in a field the forward reads;
# tests/test_torch_convert_ckpt.py holds mimic_config to that file
MIMIC_FLAGSHIP = {"z_max_res": 96, "beta": 9.0, "posterior_init_scale": 0.0}


def mimic_config(dtype="bfloat16", bs=BS):
    """The mimic192 flagship's configuration: the registry's mimic192 with
    the flagship's z_max_res 96 (bias_max_res 64, the GELU blocks, full width
    and depth), beta and zero-initialised posterior heads."""
    from causal_gen_tpu_torch.config import get_config

    return get_config("mimic192").replace(**MIMIC_FLAGSHIP, bs=bs, dtype=dtype)


def build_mimic(cfg, device, state=None):
    """A MIMIC DSCM: the HVAE, ChestPGM as PGM and as predictor (the ResNet-18
    trunk), as cli/train_cf.py builds it. Weights from the seed as flax
    initialises them, then every all-zero leaf (the flagship zero-initialises
    the prior and posterior heads, so q == p, and the biases) given
    0.05 N(0, 1) from the seed, so that every path carries signal; or
    ``state``."""
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.pgm.dscm import DSCM
    from causal_gen_tpu_torch.pgm.flow_pgm import ChestPGM

    g = torch.Generator().manual_seed(SEED)
    mods = (HVAE(cfg, device=device, generator=g),
            ChestPGM(setup_predictors=False, device=device, generator=g),
            ChestPGM(setup_predictors=True, input_res=cfg.input_res, device=device, generator=g))
    for mod, sd in zip(mods, state or [None] * 3):
        if sd is not None:
            mod.load_state_dict(sd)
        else:
            fill_zero_leaves(mod, g)
    return DSCM(cfg, mods[1], mods[2], mods[0])


def fill_zero_leaves(mod, g):
    """In place: every all-zero parameter of ``mod`` given 0.05 N(0, 1) from
    ``g`` (flax zero-initialises the prior heads, the posterior heads where
    ``posterior_init_scale`` is 0, and the biases)."""
    import torch

    with torch.no_grad():
        for p in mod.parameters():
            if not p.any():
                p.add_(0.05 * torch.randn(p.shape, generator=g).to(p.device))


def mimic_obs(cfg, n, device, seed=SEED):
    """A batch in the PGM's space: x in [-1, 1], sex and finding 0/1, age in
    [-0.8, 0.8], race one-hot(3)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    res = cfg.input_res
    obs = {"x": rng.uniform(-1, 1, (n, 1, res, res)), "sex": rng.integers(0, 2, (n, 1)),
           "age": rng.uniform(-0.8, 0.8, (n, 1)), "race": np.eye(3)[rng.integers(0, 3, n)],
           "finding": rng.integers(0, 2, (n, 1))}
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in obs.items()}


def mimic_do(kind, obs):
    """do(age = -0.6) (the finding then follows its Gumbel posterior) or
    do(finding = 1 - finding)."""
    import torch

    if kind == "age":
        return {"age": torch.full_like(obs["age"], -0.6)}
    return {"finding": 1.0 - obs["finding"]}


def phase_mimic():
    """DSCM.forward on the mimic192 flagship's configuration in bf16 at bs BS
    under inference_mode: K1 against its plain version at the main path's
    shapes; card against the CPU plain path at bs CHECK_BS in
    float32 and bf16 under do(age) and do(finding), every draw injected (the
    posterior normals and both Gumbel draws); the main path do(age) with the
    launch counts read around it; the time of a forward, the profiler, and
    the ResNet-18 trunk's device time."""
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = mimic_config()
    dscm = build_mimic(cfg, "cuda")
    enc_k2, dec_k2 = k2_cover(dscm.vae)
    n_sto = len(k1_res(cfg))
    out = {"config": f"mimic192 flagship (registry mimic192 with {MIMIC_FLAGSHIP}: z_max_res "
                     f"{cfg.z_max_res}, bias_max_res {cfg.bias_max_res}, block_version "
                     f"{cfg.block_version}), bf16",
           "k2_blocks": {"encoder": enc_k2, "decoder": dec_k2}, "stochastic_blocks": n_sto,
           "k1_bound_ms_per_forward": 2 * 28 * sum(BS * cfg.z_dim * r * r for r in k1_res(cfg))
           / HBM_BYTES_PER_S * 1e3}
    # K1 at the shapes the main path gives it (the Morpho-MNIST shapes of
    # phase K1 are others)
    out["k1_max_abs_err"] = k1_check(k1_shapes(cfg), torch.Generator().manual_seed(SEED + 113))
    log("mimic", f"K1 (injected eps): kernel == plain version within 1e-6*(1+|ref|) at "
                 f"{k1_shapes(cfg)}; max abs err {out['k1_max_abs_err']:.3e}")
    with torch.inference_mode():
        # card against the CPU plain path: same weights, batch and draws
        out["card_vs_cpu"] = {}
        state = [{k: v.cpu() for k, v in m.state_dict().items()}
                 for m in (dscm.vae, dscm.pgm, dscm.predictor)]
        obs_c = mimic_obs(cfg, CHECK_BS, torch.device("cpu"), seed=SEED + 111)
        rng = np.random.default_rng(SEED + 112)
        normal = [torch.from_numpy(rng.standard_normal((CHECK_BS, cfg.z_dim, r, r))
                                   .astype(np.float32)) for r in k1_res(cfg) * 2]
        gumbel = [torch.from_numpy(rng.gumbel(size=s).astype(np.float32))
                  for s in ((CHECK_BS, 1), (CHECK_BS, 2))]
        noise = normal[:n_sto] + gumbel + normal[n_sto:]
        for dtype in ("float32", "bfloat16"):
            c = mimic_config(dtype, CHECK_BS)
            gpu_d, cpu_d = build_mimic(c, "cuda", state), build_mimic(c, "cpu", state)
            for kind in ("age", "finding"):
                do_c = mimic_do(kind, obs_c)
                reset_counts()
                gpu = gpu_d.forward({k: v.to(dev) for k, v in obs_c.items()},
                                    {k: v.to(dev) for k, v in do_c.items()},
                                    noise=[e.to(dev) for e in noise])
                torch.cuda.synchronize()
                counts_c = read_counts()
                cpu = cpu_d.forward(obs_c, do_c, noise=noise)
                err = (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs()
                rel = {k: abs(gpu[k].item() - cpu[k].item()) / max(abs(cpu[k].item()), 1e-30)
                       for k in ("elbo", "nll", "kl", "aux_loss", "loss")}
                parents_equal = all(torch.allclose(gpu["cfs"][k].cpu(), cpu["cfs"][k], rtol=0,
                                                   atol=1e-5) for k in MIMIC_VARS)
                entry = {"cf_x_max_abs_err": err.max().item(), "rel_err": rel,
                         "launches": counts_c, "parents_equal": parents_equal,
                         "findings_changed": int((cpu["cfs"]["finding"] != obs_c["finding"])
                                                 .sum())}
                if dtype == "float32":
                    ok = err.max().item() <= 1e-4 and max(rel.values()) <= 1e-4
                    what = "cf_x within 1e-4 abs, every term within 1e-4 rel"
                else:
                    bound = ukbb_transfer_bound(cpu_d, obs_c, cpu, noise[n_sto + 2:])
                    entry["cf_x_err_over_bound"] = (err / bound).max().item()
                    ok = entry["cf_x_err_over_bound"] <= 1 and \
                        max(rel[k] for k in ("elbo", "nll", "kl")) <= 2e-2 and \
                        rel["aux_loss"] <= 2.0 ** -4
                    what = ("cf_x within the transfer's bound (eps 2^-4), elbo/nll/kl within "
                            "2e-2 rel, aux_loss within 2^-4 rel")
                want = dict({k: 0 for k in counts_c}, fused_sample_kl=2 * n_sto)
                out["card_vs_cpu"][f"{dtype} do({kind})"] = entry
                if not (ok and parents_equal and counts_c == want):
                    raise AssertionError(f"mimic192 DSCM.forward {dtype} do({kind}) card vs CPU "
                                         f"(launches expected {want}): {entry}")
                log("mimic", f"{dtype} do({kind}) bs {CHECK_BS}: card == CPU plain path ({what}; "
                             f"the counterfactual parents within 1e-5; "
                             f"{entry['findings_changed']} findings changed): cf_x max abs err "
                             f"{err.max().item():.3e}"
                    + (f" ({entry['cf_x_err_over_bound']:.3f} of the bound)"
                       if dtype != "float32" else "") + "; "
                    + ", ".join(f"{k} rel {v:.2e}" for k, v in rel.items()))
            del gpu_d, cpu_d

        # the main path: counts set to 0 just before, read just after
        obs = mimic_obs(cfg, BS, dev)
        do = mimic_do("age", obs)
        g = torch.Generator().manual_seed(SEED + 110)
        reset_counts()
        res = dscm.forward(obs, do, generator=g)
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict({k: 0 for k in counts}, fused_sample_kl=2 * n_sto)
        if counts != want or enc_k2 or dec_k2:
            raise AssertionError(f"mimic192 DSCM.forward: launches {counts}, expected {want} "
                                 f"(K2 covers {enc_k2} + {dec_k2} blocks, expected none)")
        cf_x = res["cfs"]["x"]
        if cf_x.shape != obs["x"].shape or cf_x.dtype != torch.float32 \
                or not torch.isfinite(cf_x).all() or cf_x.abs().max() > 1 \
                or res["cfs"]["race"].shape != (BS, 3) \
                or not set(res["cfs"]["finding"].unique().tolist()) <= {0.0, 1.0} \
                or not all(torch.isfinite(res[k]) for k in ("elbo", "nll", "kl", "aux_loss",
                                                              "loss")):
            raise AssertionError("mimic192 main path: cf_x, a parent or a loss term is malformed")
        out["launches"] = counts
        out["findings_changed"] = int((res["cfs"]["finding"] != obs["finding"]).sum())
        log("mimic", f"main path {out['config']} DSCM.forward do(age = -0.6) bs {BS}: launches "
                     f"{counts} (K1 2 x {n_sto}; K2 covers no block: the flagship's blocks are "
                     f"GELU 1x1-3x3-3x3-1x1, not light); {out['findings_changed']} findings "
                     f"changed; elbo {res['elbo'].item():.5f}")

        times = forward_times(dscm, obs, do, g)
        out["profile"] = profile_calls(lambda: dscm.forward(obs, do, generator=g), 3, "forward")
        feats_in = res["cfs"]["x"]
        out["trunk_ms"] = cuda_time_ms([lambda: dscm.predictor.trunk(feats_in)], reps=20,
                                       per_graph=4)
    ms = statistics.median(times)
    device_ms = out["profile"].get("device_ms_per_forward")
    out.update({"forward_ms": ms, "forward_ms_all": times, "cf_per_s": BS / ms * 1e3,
                "trunk_share_of_device": None if not device_ms else out["trunk_ms"] / device_ms,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    log("mimic", f"mimic192 bf16 DSCM.forward bs {BS}: median {ms:.3f} ms over 20 calls (min "
                 f"{min(times):.3f}, max {max(times):.3f}) = {BS / ms * 1e3:.1f} cf/s; the "
                 f"ResNet-18 trunk {out['trunk_ms']:.3f} ms of device time a call at bs {BS}"
                 + (f" ({out['trunk_share_of_device']:.1%} of a forward's)" if device_ms else "")
                 + f"; K1's bound a forward {out['k1_bound_ms_per_forward']:.3f} ms")
    reset_counts()
    return out


VARIANTS = {"cond_prior": {"cond_prior": True}, "q_correction": {"q_correction": True}}
MIXTURE_ALPHA = 0.65


def variant_config(variant, bs=BS):
    """The registry's morphomnist (full width and depth, float32) with
    ``cond_prior`` (checkpoints/final_morpho_cp's configuration:
    cond_drop_from 2, context 12) or ``q_correction``."""
    from causal_gen_tpu_torch.config import get_config

    return get_config("morphomnist", bs=bs, **VARIANTS[variant])


def build_variant(cfg, device, state=None):
    """A Morpho-MNIST DSCM (``build_slice``) on ``cfg``'s HVAE, its all-zero
    leaves filled (``fill_zero_leaves``: the zero prior heads would keep the
    parents from every prior), or ``state``."""
    import torch

    dscm = build_slice(cfg, device, state)
    if state is None:
        fill_zero_leaves(dscm.vae, torch.Generator().manual_seed(SEED + 120))
    return dscm


def state_of(*mods):
    return [{k: v.cpu() for k, v in m.state_dict().items()} for m in mods]


def normals(cfg, n, rng, passes=1):
    """Standard normals for ``passes`` passes of every stochastic block, as
    CPU tensors (z_dim, r, ..., r each)."""
    import numpy as np
    import torch

    nd = cfg.spatial_dims
    return [torch.from_numpy(rng.standard_normal((n, cfg.z_dim) + (r,) * nd).astype(np.float32))
            for r in k1_res(cfg) * passes]


def k1_bounds(cfg, bs, passes):
    """The least device time of K1's launches in ``passes`` posterior passes
    at batch ``bs`` (28 B an element), and of K1's and K1-bwd's in one train
    step (28 and 40 B an element), from device memory."""
    elems = sum(bs * cfg.z_dim * r ** cfg.spatial_dims for r in k1_res(cfg))
    return {"k1_bound_ms_per_call": passes * 28 * elems / HBM_BYTES_PER_S * 1e3,
            "k1_bound_ms_per_step": 28 * elems / HBM_BYTES_PER_S * 1e3,
            "k1_bwd_bound_ms_per_step": 40 * elems / HBM_BYTES_PER_S * 1e3}


def rel_errs(gpu, cpu, keys):
    return {k: abs(float(gpu[k]) - float(cpu[k])) / max(abs(float(cpu[k])), 1e-30) for k in keys}


def step_card_vs_cpu(cfg, model_state, batch, draws, elbo_rtol, params_held):
    """One train step on the card and on the CPU from ``model_state`` with the
    same batch and ``draws``: the metrics' rel errors (at most ``elbo_rtol``)
    and, with ``params_held``, the parameters within 2 lr (Adam moves an
    element at most lr a step, so an element whose tiny gradient takes
    another sign on the card ends at most 2 lr apart). Returns the errors."""
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import to_device, train_step

    ms, states = {}, {}
    for d in ("cpu", "cuda"):
        m = HVAE(cfg, device=d)
        m.load_state_dict(model_state)
        st = states[d] = init_train_state(cfg, m)
        lr = st.optimizer.param_groups[0]["lr"]
        out = train_step(cfg, st, to_device(batch, torch.device(d)),
                         noise=[[e.to(d) for e in draws]])
        ms[d] = {k: float(v) for k, v in out.items()}
    rel = rel_errs(ms["cuda"], ms["cpu"], ("elbo", "nll", "kl", "grad_norm"))
    out = {"rel_err": rel, "cpu": ms["cpu"]}
    if ms["cuda"]["skipped"] or ms["cpu"]["skipped"] or \
            max(rel[k] for k in ("elbo", "nll", "kl")) > elbo_rtol:
        raise AssertionError(f"train step card vs CPU: {ms}")
    if params_held:
        ref, got = states["cpu"].model.state_dict(), states["cuda"].model.state_dict()
        err = max((got[k].cpu() - ref[k]).abs().max().item() for k in ref)
        out["params_max_abs_err"] = err
        if rel["grad_norm"] > elbo_rtol or err > 2 * lr + 1e-6:
            raise AssertionError(f"train step card vs CPU: grad_norm rel {rel['grad_norm']:.3e}, "
                                 f"params max err {err:.3e} > 2 lr = {2 * lr:.3e}")
    return out


def phase_cond_prior():
    """The conditional prior and q_correction HVAEs on the registry's
    morphomnist at full width and depth, float32, seeded weights: card
    against the CPU plain path at bs CHECK_BS with every draw injected
    (DSCM.forward do(thickness); the mixture abduction; one train step for
    each dropout option); the main paths (DSCM.forward, the mixture
    abduction, a train step) with the launch counts read around each; the
    times of a forward at bs BS under inference_mode and of a train step,
    and the profiler."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.pgm.dscm import vae_preprocess
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import to_device, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu_dev = torch.device("cuda"), torch.device("cpu")
    out = {}
    for variant in VARIANTS:
        cfg = variant_config(variant)
        dscm = build_variant(cfg, "cuda")
        n_sto = len(k1_res(cfg))
        res = out[variant] = {"card_vs_cpu": {}}
        rng = np.random.default_rng(SEED + 121)
        c = variant_config(variant, CHECK_BS)
        state = state_of(dscm.vae, dscm.pgm, dscm.predictor)
        gpu_d, cpu_d = build_variant(c, "cuda", state), build_variant(c, "cpu", state)
        obs_c = {k: v[:CHECK_BS].cpu() for k, v in synth_obs(c, cpu_dev).items()}
        do_c = {"thickness": torch.full((CHECK_BS, 1), 0.5)}
        with torch.inference_mode():
            noise = normals(c, CHECK_BS, rng, passes=2)
            gpu = gpu_d.forward({k: v.to(dev) for k, v in obs_c.items()},
                                {k: v.to(dev) for k, v in do_c.items()},
                                noise=[e.to(dev) for e in noise])
            cpu = cpu_d.forward(obs_c, do_c, noise=noise)
            err = (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs().max().item()
            rel = rel_errs(gpu, cpu, ("elbo", "nll", "kl", "aux_loss", "loss"))
            res["card_vs_cpu"]["DSCM.forward"] = {"cf_x_max_abs_err": err, "rel_err": rel}
            if err > 1e-4 or max(rel.values()) > 1e-4:
                raise AssertionError(f"{variant} DSCM.forward card vs CPU: cf_x {err:.3e}, {rel}")
            msg = [f"DSCM.forward do(thickness) cf_x {err:.2e}, terms rel "
                   f"{max(rel.values()):.2e}"]
            if variant == "cond_prior":
                pa = vae_preprocess(c, {k: v for k, v in obs_c.items() if k != "x"})
                cf_pa = pa.clone()
                cf_pa[:, 0] = 0.5
                noise = normals(c, CHECK_BS, rng, passes=2)
                got = gpu_d.vae.abduct(obs_c["x"].to(dev), pa.to(dev), cf_pa.to(dev),
                                       MIXTURE_ALPHA, noise=iter([e.to(dev) for e in noise]))
                ref = cpu_d.vae.abduct(obs_c["x"], pa, cf_pa, MIXTURE_ALPHA, noise=iter(noise))
                err = max((a.cpu() - b).abs().max().item() for a, b in zip(got, ref))
                res["card_vs_cpu"]["mixture abduct"] = {"max_abs_err": err}
                if err > 1e-4 or len(got) != n_sto:
                    raise AssertionError(f"mixture abduct card vs CPU: max err {err:.3e}")
                msg.append(f"mixture abduct (alpha {MIXTURE_ALPHA}) latents {err:.2e}")
        del gpu_d, cpu_d
        batch = synth_batch(c, rng)
        draws = normals(c, CHECK_BS, rng)
        options = (0, 1, 2) if variant == "cond_prior" else (None,)
        kl_by_option = {}
        for opt in options:
            head = [] if opt is None else [torch.tensor(opt)]
            e = step_card_vs_cpu(c, state[0], batch, head + draws, 1e-4, True)
            kl_by_option[opt] = e["cpu"]["kl"]
            res["card_vs_cpu"][f"train step option {opt}"] = e
            msg.append(f"train step{'' if opt is None else f' option {opt}'} metrics rel "
                       f"{max(e['rel_err'].values()):.2e}, params {e['params_max_abs_err']:.2e}")
        if variant == "cond_prior" and not (kl_by_option[0] != kl_by_option[1] ==
                                            kl_by_option[2]):
            raise AssertionError(f"dropout options: KL {kl_by_option}; option 0 must move it")
        log("cond_prior", f"{variant} bs {CHECK_BS}: card == CPU plain path (TF32 off, draws "
                          f"injected): " + "; ".join(msg))

        # the main paths: counts set to 0 just before each, read just after
        obs = synth_obs(cfg, dev)
        do = {"thickness": torch.full((BS, 1), 0.5, device=dev)}
        g = torch.Generator().manual_seed(SEED + 122)
        zero = dict.fromkeys(read_counts(), 0)
        paths = {"DSCM.forward": (lambda: dscm.forward(obs, do, generator=g),
                                  dict(zero, fused_sample_kl=2 * n_sto))}
        if variant == "cond_prior":
            pa = vae_preprocess(cfg, {k: v for k, v in obs.items() if k != "x"})
            cf_pa = pa.clone()
            cf_pa[:, 0] = 0.5
            paths["HVAE.abduct mixture"] = (
                lambda: dscm.vae.abduct(obs["x"], pa, cf_pa, MIXTURE_ALPHA, generator=g),
                dict(zero, fused_sample_kl=n_sto))
        res["launches"] = {}
        with torch.inference_mode():
            for name, (fn, want) in paths.items():
                reset_counts()
                r = fn()
                torch.cuda.synchronize()
                counts = read_counts()
                res["launches"][name] = counts
                ok = all(torch.isfinite(t).all() for t in (
                    [r["cfs"]["x"], r["elbo"], r["loss"]] if isinstance(r, dict) else r))
                if counts != want or not ok:
                    raise AssertionError(f"{variant} {name}: launches {counts}, expected {want}; "
                                         f"finite {ok}")
        st = init_train_state(cfg, dscm.vae)
        b = to_device(synth_batch(cfg, rng), dev)
        reset_counts()
        m = train_step(cfg, st, b, generator=g)
        torch.cuda.synchronize()
        counts = read_counts()
        res["launches"]["train_step"] = counts
        if counts != expected_counts(cfg, 1) or not math.isfinite(float(m["elbo"])):
            raise AssertionError(f"{variant} train step: launches {counts}, expected "
                                 f"{expected_counts(cfg, 1)}; {m}")
        log("cond_prior", f"{variant} main paths at bs {BS}: " + "; ".join(
            f"{k} {v['fused_sample_kl']} K1 + {v['fused_sample_kl_bwd']} K1-bwd, K2 "
            f"{v['fused_light_block']}" for k, v in res["launches"].items()))
        if variant != "cond_prior":
            continue
        with torch.inference_mode():
            times = forward_times(dscm, obs, do, g)
            res["profile_forward"] = profile_calls(lambda: dscm.forward(obs, do, generator=g), 3,
                                                   "forward")
        for _ in range(2):
            train_step(cfg, st, b, generator=g)
        step_times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(cfg, st, b, generator=g)
            torch.cuda.synchronize()
            step_times.append((time.perf_counter() - t0) * 1e3)
        res["profile_step"] = profile_calls(lambda: train_step(cfg, st, b, generator=g), 3, "step")
        fwd, step = statistics.median(times), statistics.median(step_times)
        res.update({"forward_ms": fwd, "forward_ms_all": times, "cf_per_s": BS / fwd * 1e3,
                    "step_ms": step, "step_ms_all": step_times,
                    "images_per_s": BS / step * 1e3, **k1_bounds(cfg, BS, 2)})
        log("cond_prior", f"cond_prior bs {BS}: DSCM.forward median {fwd:.3f} ms over 20 (min "
                          f"{min(times):.3f}, max {max(times):.3f}) = {BS / fwd * 1e3:.1f} cf/s; "
                          f"train step median {step:.3f} ms over 10 (min {min(step_times):.3f}, "
                          f"max {max(step_times):.3f}) = {BS / step * 1e3:.1f} images/s; bounds: "
                          f"K1 {res['k1_bound_ms_per_call']:.4f} ms a forward, K1 + K1-bwd "
                          f"{res['k1_bound_ms_per_step']:.4f} + "
                          f"{res['k1_bwd_bound_ms_per_step']:.4f} ms a step")
    reset_counts()
    return out


VOL3D_BS = 8  # the registry's vol3d32 batch


def vol3d_config(dtype="bfloat16", bs=VOL3D_BS):
    """The registry's vol3d32: widths 8-64, 32^3, light blocks, bf16."""
    from causal_gen_tpu_torch.config import get_config

    return get_config("vol3d32", bs=bs, dtype=dtype)


def vol3d_obs(cfg, n, device, seed=SEED):
    """Spheres of the vol3d builder (``make_vol3d``), x NCDHW in [-1, 1], the
    parents (radius, intensity) in [-1, 1], and do(radius = 0.6)."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.data.datasets import VOL3D_MIN_MAX, make_vol3d
    from causal_gen_tpu_torch.utils.normalization import normalize

    vols, raw = make_vol3d(n, cfg.input_res, seed=seed)
    x = torch.from_numpy((vols.astype(np.float32) - 127.5) / 127.5).permute(0, 4, 1, 2, 3)
    pa = torch.from_numpy(np.stack([normalize(raw[k], *VOL3D_MIN_MAX[k]) for k in cfg.parents_x],
                                   axis=1).astype(np.float32))
    cf_pa = pa.clone()
    cf_pa[:, 0] = 0.6
    return x.contiguous().to(device), pa.to(device), cf_pa.to(device)


def hvae_counterfactual(vae, x, pa, cf_pa, noise=None, generator=None):
    """DSCM.forward's HVAE part, with the parents given: the ELBO
    (train=False), the abduction, the decodes under ``pa`` and ``cf_pa`` and
    the transfer cf_x = clip(cf_loc + cf_scale u), u = (x - rec_loc) /
    rec_scale. ``noise`` is one iterator for both passes."""
    import torch

    out = vae(x, pa, noise=noise, generator=generator, train=False)
    zs = vae.abduct(x, pa, noise=noise, generator=generator)
    cf_loc, cf_scale = vae.forward_latents(zs, cf_pa)
    rec_loc, rec_scale = vae.forward_latents(zs, pa)
    u = (x - rec_loc) / torch.clamp(rec_scale, min=1e-12)
    return dict(out, cf_x=torch.clamp(cf_loc + cf_scale * u, -1.0, 1.0), u=u,
                cf_scale=cf_scale, rec_scale=rec_scale)


def phase_vol3d():
    """The registry's vol3d32 (3-D, bf16, light blocks, seeded weights, the
    zero heads filled): K1 and K1-bwd against their plain versions at every
    (8, 8, r, r, r) of the path; card against the CPU plain path at bs
    CHECK_BS in bf16 and float32 (the HVAE counterfactual under do(radius),
    one train step, HVAE.sample at t 0.7); the main paths at bs 8 (the
    counterfactual, a train step, a sample) with the launch counts read
    around each, K2's 0 among them; their times and the profiler."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import to_device, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu_dev = torch.device("cuda"), torch.device("cpu")
    cfg = vol3d_config()
    n_sto = len(k1_res(cfg))
    shapes = [(VOL3D_BS, cfg.z_dim) + (r,) * 3 for r in sorted(set(k1_res(cfg)))]
    g = torch.Generator().manual_seed(SEED + 130)
    out = {"config": "vol3d32 (registry: widths 8-64, 32^3, light blocks), bf16",
           "k1_shapes": shapes, "k1_max_abs_err": k1_check(shapes, g),
           "k1_bwd_max_abs_err": k1_bwd_check(shapes, g)}
    log("vol3d", f"K1 == plain version within 1e-6*(1+|ref|) and K1-bwd == autograd of it within "
                 f"1e-5*(1+|ref|) (injected eps and Philox; the KL's cotangent stride 0 over "
                 f"(D, H, W)) at {shapes}: max abs err {out['k1_max_abs_err']:.3e}, "
                 f"{out['k1_bwd_max_abs_err']:.3e}")
    vae = HVAE(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    fill_zero_leaves(vae, torch.Generator().manual_seed(SEED + 131))
    if any(b.k2_covered for b in vae.modules() if hasattr(b, "k2_covered")):
        raise AssertionError("vol3d32: a 3-D block claims K2's 2-D body")
    state = state_of(vae)[0]
    rng = np.random.default_rng(SEED + 132)
    x_c, pa_c, cf_c = vol3d_obs(cfg, CHECK_BS, cpu_dev, seed=SEED + 133)
    e = 2.0 ** -4
    out["card_vs_cpu"] = {}
    for dtype in ("bfloat16", "float32"):
        c = vol3d_config(dtype, CHECK_BS)
        gpu_m, cpu_m = HVAE(c, device="cuda"), HVAE(c, device="cpu")
        gpu_m.load_state_dict(state)
        cpu_m.load_state_dict(state)
        entry = out["card_vs_cpu"][dtype] = {}
        with torch.inference_mode():
            noise = normals(c, CHECK_BS, rng, passes=2)
            reset_counts()
            gpu = hvae_counterfactual(gpu_m, x_c.to(dev), pa_c.to(dev), cf_c.to(dev),
                                      noise=iter([t.to(dev) for t in noise]))
            torch.cuda.synchronize()
            entry["launches"] = read_counts()
            cpu = hvae_counterfactual(cpu_m, x_c, pa_c, cf_c, noise=iter(noise))
            err = (gpu["cf_x"].cpu() - cpu["cf_x"]).abs()
            rel = rel_errs(gpu, cpu, ("elbo", "nll", "kl"))
            if dtype == "float32":
                limit = torch.full_like(err, 1e-4)
                rtol = 1e-4
            else:  # the transfer's bound from the CPU run's own decodes
                limit = e * (1 + 2 * (cpu["cf_scale"] * cpu["u"]).abs()
                             + cpu["cf_scale"] / cpu["rec_scale"])
                rtol = 2e-2
            entry.update({"cf_x_max_abs_err": err.max().item(),
                          "cf_x_err_over_limit": (err / limit).max().item(), "rel_err": rel})
            if entry["cf_x_err_over_limit"] > 1 or max(rel.values()) > rtol or \
                    entry["launches"]["fused_sample_kl"] != 2 * n_sto or \
                    entry["launches"]["fused_light_block"]:
                raise AssertionError(f"vol3d32 {dtype} counterfactual card vs CPU: {entry}")
            # HVAE.sample(return_loc=False, t=0.7) with the draws injected
            prior = normals(c, CHECK_BS, rng)
            head = torch.from_numpy(rng.standard_normal(tuple(x_c.shape)).astype(np.float32))
            sx, ss = gpu_m.sample(pa_c.to(dev), False, 0.7,
                                  noise=iter([t.to(dev) for t in prior + [head]]))
            rx, rs = cpu_m.sample(pa_c, False, 0.7, noise=iter(prior + [head]))
            x_err, s_err = (sx.cpu() - rx).abs(), (ss.cpu() - rs).abs()
            if dtype == "float32":
                x_lim, s_lim = torch.full_like(x_err, 1e-4), torch.full_like(s_err, 1e-4)
            else:  # x = loc + scale eps: loc within e, the scale within e relative
                x_lim, s_lim = e * (1 + 2 * (rs * head).abs()), e * rs
            entry["sample_err_over_limit"] = max((x_err / x_lim).max().item(),
                                                 (s_err / s_lim).max().item())
            if entry["sample_err_over_limit"] > 1:
                raise AssertionError(f"vol3d32 {dtype} HVAE.sample card vs CPU: {entry}")
        batch = {"x": np.round((x_c.permute(0, 2, 3, 4, 1).numpy() + 1) * 127.5).astype(np.uint8),
                 "pa": pa_c.numpy()}
        st = step_card_vs_cpu(c, state, batch, normals(c, CHECK_BS, rng),
                              2e-2 if dtype == "bfloat16" else 1e-4, dtype == "float32")
        entry["train_step"] = st
        log("vol3d", f"{dtype} bs {CHECK_BS}: card == CPU plain path (TF32 off, draws injected): "
                     f"counterfactual do(radius = 0.6) cf_x max abs err "
                     f"{entry['cf_x_max_abs_err']:.3e} ({entry['cf_x_err_over_limit']:.3f} of "
                     f"the {'bound' if dtype != 'float32' else '1e-4'}), terms rel "
                     f"{max(rel.values()):.2e}; sample {entry['sample_err_over_limit']:.3f} of "
                     f"its limit; train step metrics rel {max(st['rel_err'].values()):.2e}")
        del gpu_m, cpu_m

    # the main paths at bs 8: counts set to 0 just before each, read just after
    x, pa, cf_pa = vol3d_obs(cfg, VOL3D_BS, dev)
    g = torch.Generator().manual_seed(SEED + 134)
    zero = dict.fromkeys(read_counts(), 0)
    out["launches"] = {}
    with torch.inference_mode():
        for name, fn, want in (
                ("counterfactual", lambda: hvae_counterfactual(vae, x, pa, cf_pa, generator=g),
                 dict(zero, fused_sample_kl=2 * n_sto)),
                ("HVAE.sample", lambda: vae.sample(pa, False, 0.7, generator=g), zero)):
            reset_counts()
            r = fn()
            torch.cuda.synchronize()
            counts = out["launches"][name] = read_counts()
            vals = [r["cf_x"], r["elbo"]] if isinstance(r, dict) else list(r)
            if counts != want or not all(torch.isfinite(t).all() for t in vals):
                raise AssertionError(f"vol3d32 {name}: launches {counts}, expected {want}")
    st = init_train_state(cfg, vae)
    b = to_device({"x": np.round((x.permute(0, 2, 3, 4, 1).cpu().numpy() + 1) * 127.5)
                   .astype(np.uint8), "pa": pa.cpu().numpy()}, dev)
    reset_counts()
    m = train_step(cfg, st, b, generator=g)
    torch.cuda.synchronize()
    counts = out["launches"]["train_step"] = read_counts()
    if counts != expected_counts(cfg, 1) or not math.isfinite(float(m["elbo"])):
        raise AssertionError(f"vol3d32 train step: launches {counts}, expected "
                             f"{expected_counts(cfg, 1)}; {m}")
    log("vol3d", f"main paths bf16 bs {VOL3D_BS}: " + "; ".join(
        f"{k} {v['fused_sample_kl']} K1 + {v['fused_sample_kl_bwd']} K1-bwd, K2 "
        f"{v['fused_light_block']}" for k, v in out["launches"].items()))

    with torch.inference_mode():
        for _ in range(3):
            hvae_counterfactual(vae, x, pa, cf_pa, generator=g)
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hvae_counterfactual(vae, x, pa, cf_pa, generator=g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["profile_counterfactual"] = profile_calls(
            lambda: hvae_counterfactual(vae, x, pa, cf_pa, generator=g), 3, "counterfactual")
    for _ in range(2):
        train_step(cfg, st, b, generator=g)
    step_times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(cfg, st, b, generator=g)
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - t0) * 1e3)
    out["profile_step"] = profile_calls(lambda: train_step(cfg, st, b, generator=g), 3, "step")
    cf_ms, step_ms = statistics.median(times), statistics.median(step_times)
    out.update({"counterfactual_ms": cf_ms, "counterfactual_ms_all": times,
                "cf_per_s": VOL3D_BS / cf_ms * 1e3, "step_ms": step_ms,
                "step_ms_all": step_times, "volumes_per_s": VOL3D_BS / step_ms * 1e3,
                **k1_bounds(cfg, VOL3D_BS, 2)})
    log("vol3d", f"vol3d32 bf16 bs {VOL3D_BS}: counterfactual median {cf_ms:.3f} ms over 20 (min "
                 f"{min(times):.3f}, max {max(times):.3f}) = {VOL3D_BS / cf_ms * 1e3:.1f} cf/s; "
                 f"train step median {step_ms:.3f} ms over 10 (min {min(step_times):.3f}, max "
                 f"{max(step_times):.3f}) = {VOL3D_BS / step_ms * 1e3:.1f} volumes/s; bounds: K1 "
                 f"{out['k1_bound_ms_per_call']:.4f} ms a counterfactual, K1 + K1-bwd "
                 f"{out['k1_bound_ms_per_step']:.4f} + {out['k1_bwd_bound_ms_per_step']:.4f} ms "
                 f"a step")
    reset_counts()
    return out


def turn(tree):
    """One turn of the comparison of two trees' kernels, run in a process of
    its own with ``tree``'s package first on the path: K2's float32 kernel
    at every ukbb64 and ukbb192 shape, K4 in both modes with its outputs'
    digests (k4_time), and the wall and K2's device time of a ukbb64
    DSCM.forward. Returns what it measured."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    from causal_gen_tpu_torch.ops import build

    build.build_all()
    out = {"tree": tree, "package": build.__file__,
           "k2_f32_ms": {str(s_): k2_time(*s_, torch.float32, dev, keys=("ms",))["ms"]
                         for s_ in UKBB64_K2_SHAPES + UKBB_K2_SHAPES},
           "k4": k4_time(BS, 32, 32, dev, keys=("ms", "ms_injected"))}
    cfg = ukbb64_config()
    dscm = build_ukbb(cfg, "cuda")
    obs = ukbb_obs(cfg, BS, dev)
    do = {UKBB_DO: torch.full((BS, 1), 0.5, device=dev)}
    g = torch.Generator().manual_seed(SEED + 100)
    with torch.inference_mode():
        times = forward_times(dscm, obs, do, g, n=10)
        prof = profile_calls(lambda: dscm.forward(obs, do, generator=g), 3, "forward")
    out["ukbb64_forward_ms"] = statistics.median(times)
    out["ukbb64_forward_ms_all"] = times
    out["ukbb64_profile"] = {k: v for k, v in prof.items() if k != "top"}
    return out


def phase_turns(parent):
    """This tree's K2 float32 kernel, K4 and ukbb64 forward against the
    parent tree's at ``parent``, in turns (parent, this, this, parent), each
    a process of its own (``turn``); K4's digests must agree."""
    turns = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", tree],
                              capture_output=True, text=True, timeout=400)
        if proc.returncode != 0:
            raise AssertionError(f"turn in {tree} failed:\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-3000:]}")
        t = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append(t)
        which = "parent" if tree == parent else "this"
        log("turns", f"{which} tree ({t['package']}): K2 float32 us " + ", ".join(
            f"{k} {v * 1e3:.1f}" for k, v in t["k2_f32_ms"].items())
            + f"; K4 Philox {t['k4']['ms'] * 1e3:.2f} us, injected "
              f"{t['k4']['ms_injected'] * 1e3:.2f} us, sha256 {t['k4']['philox_sha256'][:16]} / "
              f"{t['k4']['injected_sha256'][:16]}; ukbb64 DSCM.forward median "
              f"{t['ukbb64_forward_ms']:.3f} ms, K2 "
              f"{t['ukbb64_profile'].get('k2_device_ms_per_forward')} ms of "
              f"{t['ukbb64_profile'].get('device_ms_per_forward')} ms device time a forward")
    for key in ("philox_sha256", "injected_sha256"):
        if len({t["k4"][key] for t in turns}) != 1:
            raise AssertionError(f"K4's outputs differ between the trees ({key})")
    return turns


TRAIN_CONFIGS = {"morphomnist": {}, "cmnist_dmol": {"x_like": "diag_dmol"}}


def train_config(name, bs=None):
    """The registry configuration of a train cell at full width and depth."""
    from causal_gen_tpu_torch.config import get_config

    return get_config(name.split("_")[0], bs=bs or BS, **TRAIN_CONFIGS[name])


def synth_batch(cfg, rng):
    """A loader batch (uint8 NHWC x, pa) of cfg.bs images made from ``rng``:
    one-hot parents where the configuration has them, else uniform in [-1, 1]."""
    import numpy as np

    res, n = cfg.input_res, cfg.bs
    return {"x": rng.integers(0, 256, (n, res, res, cfg.input_channels)).astype(np.uint8),
            "pa": synth_parents(cfg, rng, n)}


def synth_parents(cfg, rng, n):
    import numpy as np

    cols = []
    for k in cfg.parents_x:
        if k in ("digit", "colour"):
            cols.append(np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)])
        else:
            cols.append(rng.uniform(-1, 1, (n, 1)).astype(np.float32))
    return np.concatenate(cols, axis=1)


def reset_counts():
    from causal_gen_tpu_torch.ops.dmol_loss import dmol_logprob, dmol_loss_bwd
    from causal_gen_tpu_torch.ops.dmol_sample import dmol_sample
    from causal_gen_tpu_torch.ops.fused_block import fused_light_block
    from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl, fused_sample_kl_bwd

    for fn in (fused_sample_kl, fused_sample_kl_bwd, dmol_logprob, dmol_loss_bwd, dmol_sample,
               fused_light_block):
        fn.launches = 0
    fused_light_block.launches_tc = fused_light_block.launches_simt = 0


def read_counts():
    from causal_gen_tpu_torch.ops.dmol_loss import dmol_logprob, dmol_loss_bwd
    from causal_gen_tpu_torch.ops.dmol_sample import dmol_sample
    from causal_gen_tpu_torch.ops.fused_block import fused_light_block
    from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl, fused_sample_kl_bwd

    return {"fused_sample_kl": fused_sample_kl.launches,
            "fused_sample_kl_bwd": fused_sample_kl_bwd.launches,
            "dmol_loss": dmol_logprob.launches, "dmol_loss_bwd": dmol_loss_bwd.launches,
            "dmol_sample": dmol_sample.launches,
            "fused_light_block": fused_light_block.launches,
            "fused_light_block_tc": fused_light_block.launches_tc,
            "fused_light_block_simt": fused_light_block.launches_simt}


def expected_counts(cfg, train_steps, eval_batches=0):
    n_sto = len(k1_res(cfg))
    dmol = cfg.x_like.endswith("dmol")
    fwd = (train_steps * cfg.accu_steps + eval_batches)
    return {"fused_sample_kl": n_sto * fwd, "fused_sample_kl_bwd": n_sto * train_steps * cfg.accu_steps,
            "dmol_loss": fwd if dmol else 0,
            "dmol_loss_bwd": train_steps * cfg.accu_steps if dmol else 0, "dmol_sample": 0,
            "fused_light_block": 0, "fused_light_block_tc": 0, "fused_light_block_simt": 0}


def phase_train(name):
    """Card against the CPU plain path over three updates and one skipped
    step; the launch counts around one step; the time of a step."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import to_device, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config(name)
    cpu_model = HVAE(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    gpu_model = HVAE(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED + 1))
    gpu_model.load_state_dict(cpu_model.state_dict())
    states = {"cpu": init_train_state(cfg, cpu_model), "cuda": init_train_state(cfg, gpu_model)}
    stochastic = k1_res(cfg)
    rng = np.random.default_rng(SEED + 3)
    lrs, rel_errs = [], {}
    plan = ["update", "update", "skip", "update"]
    for s, kind in enumerate(plan):
        batch = synth_batch(cfg, rng)
        noise = [rng.standard_normal((cfg.bs, cfg.z_dim, r, r)).astype(np.float32)
                 for r in stochastic]
        step_cfg = cfg.replace(grad_skip=1e-6) if kind == "skip" else cfg
        if kind == "update":
            lrs.append(states["cpu"].optimizer.param_groups[0]["lr"])
        ms = {}
        for dev, st in states.items():
            d = torch.device(dev)
            m = train_step(step_cfg, st, to_device(batch, d),
                           noise=[[torch.from_numpy(e).to(d) for e in noise]])
            ms[dev] = {k: float(v) for k, v in m.items()}
        if ms["cpu"]["skipped"] != ms["cuda"]["skipped"] or \
                ms["cuda"]["skipped"] != (1.0 if kind == "skip" else 0.0):
            raise AssertionError(f"train {name} step {s} ({kind}): skipped card "
                                 f"{ms['cuda']['skipped']}, CPU {ms['cpu']['skipped']}")
        for k in ("elbo", "nll", "kl", "grad_norm"):
            rel = abs(ms["cuda"][k] - ms["cpu"][k]) / abs(ms["cpu"][k])
            rel_errs[k] = max(rel_errs.get(k, 0.0), rel)
            if not rel <= 1e-4:
                raise AssertionError(f"train {name} step {s}: {k} card {ms['cuda'][k]!r} vs "
                                     f"CPU {ms['cpu'][k]!r} (rel {rel:.3e})")
    cs, gs = states["cpu"], states["cuda"]
    counters = [(st.step, st.skipped, st.ema_updates) for st in (cs, gs)]
    if counters[0] != counters[1] or counters[0] != (3, 1, 3):
        raise AssertionError(f"train {name}: (step, skipped, ema_updates) CPU {counters[0]}, "
                             f"card {counters[1]}, expected (3, 1, 3)")
    # Adam with beta1 == beta2 moves an element by at most lr a step, so an
    # element whose tiny gradient has another sign on the card than on the
    # CPU ends at most 2 sum(lr) apart; every other element agrees to ~1e-6
    bound = 2 * sum(lrs) + 1e-6
    worst = {}
    for what, a, b in (("params", cs.model, gs.model), ("ema", cs.ema, gs.ema)):
        ref, got = a.state_dict(), b.state_dict()
        errs = {k: (got[k].cpu() - ref[k]).abs() for k in ref}
        key = max(errs, key=lambda k: errs[k].max())
        n_over = sum(int((e > 1e-5).sum()) for e in errs.values())
        worst[what] = {"max_abs_err": errs[key].max().item(), "at": key, "n_over_1e-5": n_over,
                       "n": sum(e.numel() for e in errs.values())}
        if errs[key].max().item() > bound:
            raise AssertionError(f"train {name}: {what} card vs CPU max err "
                                 f"{errs[key].max().item():.3e} at {key} > {bound:.3e}")
    log("train", f"{name} bs {cfg.bs}: 3 updates + 1 forced skip, card == CPU plain path "
                 f"(TF32 off): metrics max rel err " + ", ".join(f"{k} {v:.2e}" for k, v in
                                                                rel_errs.items())
        + "; " + "; ".join(f"{w} max abs err {v['max_abs_err']:.3e} ({v['at']}), "
                           f"{v['n_over_1e-5']} of {v['n']} over 1e-5" for w, v in worst.items())
        + f"; bound 2 sum(lr) = {bound:.2e}")

    # the main path's kernels, counted around one step (the generator's path:
    # K1 draws eps in the kernel)
    gen = torch.Generator().manual_seed(SEED + 8)
    batch = to_device(synth_batch(cfg, rng), torch.device("cuda"))
    reset_counts()
    train_step(cfg, gs, batch, generator=gen)
    torch.cuda.synchronize()
    counts, want = read_counts(), expected_counts(cfg, 1)
    if counts != want:
        raise AssertionError(f"train {name}: launches around one step {counts}, expected {want}")
    log("train", f"{name}: launches around one step {counts}")

    out = {"rel_err": rel_errs, "worst": worst, "bound": bound, "launches_per_step": counts,
           "step_ms": {}}
    for bs in ((BS, BENCH_BS) if name == "morphomnist" else (BS,)):
        c = train_config(name, bs=bs)
        if bs == BS:
            st, b = gs, batch
        else:
            st = init_train_state(c, HVAE(c, device="cuda",
                                          generator=torch.Generator().manual_seed(SEED)))
            b = to_device(synth_batch(c, rng), torch.device("cuda"))
        for _ in range(3):
            train_step(c, st, b, generator=gen)
        times = []
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(c, st, b, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        out["step_ms"][bs] = {"median": med, "all": times, "images_per_s": bs / med * 1e3}
        log("train", f"{name} bs {bs}: train step median {med:.3f} ms over 15 (min "
                     f"{min(times):.3f}, max {max(times):.3f}) = {bs / med * 1e3:.1f} images/s")
    out["profile"] = profile_calls(lambda: train_step(cfg, gs, batch, generator=gen), 3, "step")
    return out


def synth_datasets(cfg, n_train, n_valid):
    """Train and valid ArrayDatasets of 28x28 uint8 images and parents made
    from the seed, with the augmentations of the Morpho-/Colour-MNIST datasets."""
    import numpy as np

    from causal_gen_tpu_torch.data.datasets import ArrayDataset

    rng = np.random.default_rng(SEED + 4)

    def build(n, aug):
        pa = synth_parents(cfg, rng, n)
        return ArrayDataset(
            images=rng.integers(0, 256, (n, 28, 28, cfg.input_channels)).astype(np.uint8),
            attrs={"pa": pa}, columns=("pa",), aug=aug)

    res = (cfg.input_res, cfg.input_res)
    return {"train": build(n_train, ("random_crop_flip", res, (cfg.pad, cfg.pad), 0.0)),
            "valid": build(n_valid, ("center_pad", 2))}


def phase_entry(name):
    """train() through cli.main: 2 epochs of 3 batches, one evaluation, a
    checkpoint written and read back."""
    import tempfile

    import numpy as np
    import torch

    from causal_gen_tpu_torch.cli import main as cli
    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.train.checkpoint import load_checkpoint, restore_train_state
    from causal_gen_tpu_torch.train.vae_trainer import eval_step, to_device

    cfg = train_config(name)
    n_batches = 3
    datasets = synth_datasets(cfg, n_batches * BS, 2 * BS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as save_dir:
        argv = ["--hps", cfg.name, "--device", "cuda", "--epochs", "2", "--eval_freq", "2",
                "--bs", str(BS), "--max_batches", str(n_batches), "--save_dir", save_dir]
        if cfg.x_like != "diag_dgauss":
            argv += ["--x_like", cfg.x_like]
        reset_counts()
        t0 = time.perf_counter()
        state, history = cli.main(argv, datasets=datasets)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, want = read_counts(), expected_counts(cfg, 2 * n_batches, 2)
        if counts != want:
            raise AssertionError(f"entry {name}: launches {counts}, expected {want}")
        if not all(np.isfinite(history[k]) for k in ("train_elbo", "valid_elbo", "valid_nll")):
            raise AssertionError(f"entry {name}: history not finite: {history}")
        saved_cfg, payload, extra = load_checkpoint(os.path.join(save_dir, "checkpoint"))
        if saved_cfg != cfg.replace(epochs=2, eval_freq=2) or extra.get("epoch") != 2:
            raise AssertionError(f"entry {name}: checkpoint config or extras differ: {extra}")
        restored = restore_train_state(saved_cfg, HVAE(saved_cfg, device="cuda"), payload)
        for a, b in ((state.model, restored.model), (state.ema, restored.ema)):
            for k, v in a.state_dict().items():
                if not torch.equal(v, b.state_dict()[k]):
                    raise AssertionError(f"entry {name}: checkpoint round trip changed {k}")
        if (restored.step, restored.skipped, restored.ema_updates) != (
                state.step, state.skipped, state.ema_updates):
            raise AssertionError(f"entry {name}: checkpoint round trip changed the counters")
        batch = to_device(datasets["valid"].batch(np.arange(BS)), torch.device("cuda"))
        noise = [[torch.randn((BS, cfg.z_dim, r, r), generator=torch.Generator().manual_seed(i))
                  .cuda() for i, r in enumerate(k1_res(cfg))]]
        e1 = eval_step(cfg, state.ema, batch, noise=noise)
        e2 = eval_step(cfg, restored.ema, batch, noise=noise)
        if any(e1[k].item() != e2[k].item() for k in e1):
            raise AssertionError(f"entry {name}: restored EMA evaluates differently")
    log("entry", f"{name}: cli.main -> train(), 2 epochs x {n_batches} batches of {BS} + 1 eval "
                 f"in {secs:.1f} s; step {state.step}, skipped {state.skipped}; valid elbo "
                 f"{history['valid_elbo']:.4f}; checkpoint round trip exact; launches {counts}")
    return {"seconds": secs, "launches": counts, "history": history, "step": state.step,
            "skipped": state.skipped}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write every measurement to this file")
    ap.add_argument("--parent", help="an unpacked earlier tree of the repository: time its K2 "
                                     "float32 kernel, K4 and ukbb64 forward against this one's "
                                     "in turns, after every phase")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # one turn, in a process of its own
    ap.add_argument("--tune-k2", action="store_true",
                    help="only time the float32 K2 candidates at every ukbb shape and print the "
                         "fastest as ops/fused_block.py's F32_TUNED")
    args = ap.parse_args()
    if args.tune_k2:
        phase_device()
        sys.path.insert(0, ROOT)
        tune_k2()
        return 0
    if args.turn:
        sys.path.insert(0, os.path.abspath(args.turn))
        print(json.dumps(turn(args.turn), default=str), flush=True)
        return 0
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
    k1b = phase_k1_bwd(cfg)
    k3 = phase_k3()
    k4 = phase_k4()
    k2 = phase_k2()
    sl = phase_slice(cfg)
    samp = phase_sample(cfg)
    train = {n: phase_train(n) for n in TRAIN_CONFIGS}
    entry = {n: phase_entry(n) for n in TRAIN_CONFIGS}
    uk = phase_ukbb_slice()
    uk_samp = phase_ukbb_sample()
    uk_train = phase_ukbb_train()
    uk64 = phase_ukbb64()
    mim = phase_mimic()
    cp = phase_cond_prior()
    vol = phase_vol3d()
    turns = phase_turns(os.path.abspath(args.parent)) if args.parent else None
    # launches on the main paths, each counted from 0: DSCM.forward (the
    # Morpho-MNIST, ukbb192, ukbb64 and mimic192 serving slices),
    # HVAE.sample on the DMoL head and on ukbb192, train() through cli.main
    # on each configuration and the ukbb192 train step; the cond_prior and
    # q_correction forwards, mixture abduction and train steps; vol3d32's
    # counterfactual, sample and train step
    by_path = {"DSCM.forward morphomnist": {"fused_sample_kl": sl["launches"]},
               "HVAE.sample cmnist diag_dmol": samp["launches"]}
    by_path.update({f"cli.main train {n}": e["launches"] for n, e in entry.items()})
    by_path.update({"DSCM.forward ukbb192 bf16": uk["launches"],
                    "HVAE.sample ukbb192 bf16": uk_samp["launches"],
                    "train_step ukbb192 bf16": uk_train["launches"],
                    "DSCM.forward ukbb64 float32": uk64["launches"],
                    "DSCM.forward mimic192 bf16": mim["launches"]})
    by_path.update({f"{path} morphomnist {v}": c for v in VARIANTS
                    for path, c in cp[v]["launches"].items()})
    by_path.update({f"{path} vol3d32 bf16": c for path, c in vol["launches"].items()})

    # K2's float32 kernel also runs in the float32 card-vs-CPU checks, each
    # counted from 0; those launches are listed apart
    f32_checks = {"DSCM.forward ukbb192 float32 bs 2 (card vs CPU)":
                  uk["card_vs_cpu"]["float32"]["launches"],
                  "HVAE.sample ukbb192 float32 bs 2 (card vs CPU)": uk_samp["launches_f32_check"],
                  "DSCM.forward ukbb64 float32 bs 2 (card vs CPU)":
                  uk64["card_vs_cpu"]["launches"]}

    def row(kernel, source, replaces, held_by, m, paths=by_path, **extra):
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(c.get(kernel, 0) for c in paths.values()),
                "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m.get("bound_by", "bytes"),
                "library_ms": m.get("library_ms"), "held_by": held_by,
                "launches_by_path": {p: c.get(kernel, 0) for p, c in paths.items()}, **extra}

    kernels = [
        row("fused_sample_kl", "causal_gen_tpu_torch/csrc/sample_kl.cu",
            "causal_gen_tpu/ops/pallas_kernels.py:109",
            "phase K1 (injected eps at every slice shape + ragged; Philox statistics), "
            "phase mimic (injected eps at the mimic192 path's shapes) and phase vol3d "
            "(injected eps at vol3d32's (8,8,r,r,r))",
            dict(k1, max_abs_err=max(k1["max_abs_err"], mim["k1_max_abs_err"],
                                     vol["k1_max_abs_err"])),
            ms_inputs_in_l2=k1["ms_l2"], ms_philox=k1["ms_philox"],
            bound_ms_philox=k1["bound_ms_philox"]),
        row("fused_sample_kl_bwd", "causal_gen_tpu_torch/csrc/sample_kl.cu",
            "causal_gen_tpu/ops/pallas_kernels.py:136",
            "phase K1-bwd (autograd of the plain version, injected eps and Philox, every "
            "slice shape + ragged) and phase vol3d (the same at vol3d32's (8,8,r,r,r), the "
            "KL's cotangent stride 0 over (D,H,W))",
            dict(k1b, max_abs_err=max(k1b["max_abs_err"], vol["k1_bwd_max_abs_err"]))),
        row("dmol_loss", "causal_gen_tpu_torch/csrc/dmol_loss.cu",
            "causal_gen_tpu/ops/pallas_kernels.py:230",
            "phase K3 (plain op at (32,100,32,32) and a ragged size with edge and switch "
            "pixels, low_bit False and True)", k3["fwd"]),
        row("dmol_loss_bwd", "causal_gen_tpu_torch/csrc/dmol_loss.cu",
            "causal_gen_tpu/ops/pallas_kernels.py:262",
            "phase K3 (autograd of the plain op, same inputs, low_bit False and True)",
            k3["bwd"]),
        row("dmol_sample", "causal_gen_tpu_torch/csrc/dmol_sample.cu",
            "causal_gen_tpu/ops/pallas_kernels.py:342",
            "phase K4 (plain version with the same uniforms at (32,100,32,32) and a ragged "
            "size, t 0.3 and 1; Philox statistics over 2^20 pixels)", k4,
            ms_injected=k4["ms_injected"], bound_ms_dense=k4["bound_ms_dense"]),
        row("fused_light_block_tc", "causal_gen_tpu_torch/csrc/fused_block.cu",
            "causal_gen_tpu/ops/fused_block.py:190",
            "phase K2 (bf16 tensor-core kernel; plain version at (B,C,b,H,W) " +
            ", ".join(map(str, K2_SHAPES)) + ", with and without biases); ms, plain_ms, "
            "library_ms (cuDNN conv pair) and bound_ms at (32,32,192,192) b=8; times holds "
            "every ukbb192 shape", dict(k2, max_abs_err=k2["max_abs_err_bf16"]),
            times=k2["times"], per_path=k2["per_path"]),
        row("fused_light_block_simt", "causal_gen_tpu_torch/csrc/fused_block.cu",
            "causal_gen_tpu/ops/fused_block.py:190",
            "phase K2 (float32 CUDA-core kernel, TF32 off; plain version at the same shapes and "
            "ukbb64's, with and without biases); ms, plain_ms, library_ms (cuDNN conv pair, "
            "TF32 off) and bound_ms at (32,64,32,32) b=16, the ukbb64 shape of most launches; "
            "times_ukbb64 and times_ukbb192 hold every shape",
            dict(k2["f32"], max_abs_err=k2["max_abs_err_f32"]),
            times_ukbb64=k2["f32_times_ukbb64"], per_path_ukbb64=k2["f32_per_path_ukbb64"],
            times_ukbb192=k2["f32_times_ukbb192"], per_path_ukbb192=k2["f32_per_path_ukbb192"],
            launches_in_float32_checks={p: c["fused_light_block_simt"]
                                        for p, c in f32_checks.items()}),
    ]
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: {missing}")
    record = {"device": name, "nvidia_smi": smi, "build_s": build_s, "k1": k1, "k1_bwd": k1b,
              "k3": k3, "k4": k4, "k2": k2, "slice": sl, "sample": samp, "train": train,
              "entry": entry, "ukbb": uk, "ukbb_sample": uk_samp, "ukbb_train": uk_train,
              "ukbb64": uk64, "mimic": mim, "cond_prior": cp, "vol3d": vol, "turns": turns,
              "kernels": kernels,
              "total_s": time.perf_counter() - t_start}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, default=str)
    log("done", f"all phases passed in {record['total_s']:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    timer.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
