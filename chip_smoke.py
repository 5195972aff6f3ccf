#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels against their
plain versions.

    python3 chip_smoke.py [--json PATH] [--parent DIR]
    python3 chip_smoke.py --phases remat,viz,e2e [--json PATH]
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
               evaluation, a checkpoint written and read back (--viz_freq 0:
               the viz callback is held in phase viz); the launch counts
               around it are the kernels line's
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
  18. pgm_train - PGM and predictor training (pgm/train_pgm.py): Morpho-MNIST
               sup_pgm and sup_aux at bs 32, semi_sup at checkpoints/
               semisup_morpho's hparams (bs 64, sup_frac 0.1) and ChestPGM
               semi_sup at checkpoints/semi_sup_mimic's (64^2, bs 32, alpha
               0.1, the GroupNorm ResNet-18): three updates, each card
               against the CPU plain path from the same parameters, EMA and
               AdamW moments with the same batches and guide draws (losses and
               site log-probs 1e-4 rel, parameters and EMA within 2 lr), no
               kernel launched, the time of a step (median of 15), the
               profiler
  19. dense_cf - DSCM.forward(do_mask=...) on morphomnist (float32, bs 32,
               rows under no do, thickness, intensity, digit and both
               continuous ones): K1's 40 launches, card against CPU (noise
               injected), the dense rows against the sparse forward of each
               pattern, its time; ukbb192 bf16 at bs 2 under a mixed mask
               over the binary roots and the flows: K2 against its plain
               version at the path's shapes, K2's 200 launches, card against
               CPU within the transfer's bound
  20. cmnist_cf - DSCM.forward do(colour) on Colour-MNIST (the registry's
               cmnist = checkpoints/cmnist/final_cmnist's configuration,
               ColourMNISTPGM as PGM and predictor): K1 against its plain
               version at the path's shapes, the main path at bs 32 with K1's
               launches, card against CPU at bs 2, its time
  21. simple_vae - SimpleVAE + GaussNet (diag_gauss) on morphomnist, cond_prior
               off and on: three train steps card against CPU (draws and the
               dropout options injected), DSCM.forward at bs 32 and
               sample(t=0.7) card against CPU and timed; no kernel launched
  22. cf_train - counterfactual fine-tuning (pgm/train_cf.py) at the CF
               configurations of checkpoints/ukbb192_flagship/cf (bf16, bs 16,
               beta 5, wd 0.05, eps 2.3868), mimic192_flagship/cf (bs 16,
               beta 9, wd 0.1) and cf_morphomnist/final_cf_morph_tw25
               (morphomnist, bs 32, the soft-morphometry terms), seeded
               weights, grad_skip lifted: K1 and K1-bwd against their plain
               versions at the ukbb192 and mimic192 updates' shapes; card
               against the CPU plain path in float32 (ukbb192 bs 2 once,
               morphomnist twice, each update from one state: terms 1e-4 rel,
               lambda 1e-5, parameters and EMA within 2 lr); remat on against
               off on the card with one generator seed (gradients within 1e-6
               rel); the main paths with their launch counts (ukbb192 K1 +
               K1-bwd 80 + 80, with remat 160 + 80; mimic192 76 + 76;
               morphomnist 40 + 40; the ukbb192 eval step under
               inference_mode K2 200 and K1 80), the median of 6 updates,
               peak memory, the profiler on the ukbb192 update (only:
               each profile takes tens of seconds); cli.train_cf on the card (1
               epoch of 2 updates with the valid sweeps and the panel's
               forward, then --resume)
  23. remat  - the flagships' training setup: block remat (stage_scan: the
               decoder blocks of a run are the unit, their draws replayed).
               ukbb192 in float32 at bs 2 (TF32 off, cuDNN deterministic):
               gradients remat on against off within 1e-6 rel with injected
               draws and with a generator, the first step card against CPU
               (1e-4); bf16 train steps: ukbb192 at bs 128 with remat from
               48^2 (median of 10, images/s, peak memory), at bs 32 with
               remat on and off, at bs 128 without remat where 4 x the bs-32
               peak leaves 8 GB of the card free; the ukbb192 flagship's own
               HVAE (z_max_res 96) at bs 128 with and without remat; mimic192
               at bs 128 with remat everywhere; each step's K1 / K1-bwd
               launches against the config's, K2 none; the ukbb192 bs-128
               remat step profiled
  24. viz    - utils/viz.py::write_images on ukbb192 (bf16: K2 and K1),
               morphomnist with cond_prior and cmnist with the DMoL head: the
               float32 grid card against the CPU plain path on the same
               weights and draws (uint8 within 1; ukbb192 at bs 2, the others
               at the viz batch), then the viz batch cli.main draws with its
               launches and time
  25. e2e    - tools/e2e_synth_torch.py at the ukbb192 flagship config
               (192^2, bf16, stage_scan, remat from 48^2), 16 per split, bs 8,
               1 epoch, 2 CF updates, one eval seed: each of the four stages
               on its own, reading the last one's checkpoint, with its
               seconds and launches
  26. turns  - with --parent DIR (an earlier tree of the repository, unpacked):
               that tree's K2 float32 kernel at every ukbb shape, K4 in both
               modes and ukbb64 forward against this tree's, in turns (parent,
               this, this, parent), each a process of its own; K4's output
               digests must agree
  27. parallel - the mesh path (parallel/): K2 against its plain version at
               the spatially sharded ukbb192 forward's slab shapes; NCCL at
               world 1 (a morphomnist step through the mesh path against the
               same step without it); 2 gloo ranks on the one card (cuda:0):
               whether gloo's all_gather takes a CUDA tensor (PyTorch's table
               says no; the collective layer stages it through host memory),
               the registry's ukbb192 bf16 data-parallel step at global bs 32
               with injected draws against one process (ELBO terms 2e-2 rel)
               with each rank's K1 / K1-bwd launches, its step ms and peak
               memory a rank; float32 at global bs 4 (TF32 off): data, tensor
               (from 256 channels) and spatial parallel steps, parameters
               within 2 lr of one process; the spatially sharded bf16
               forward at bs 4 with K2's launches a rank. Its numbers are 2
               ranks on one card, not multi-GPU scaling figures
  28. tail   - the last modules: the native augment pass (data/native.py)
               built here from native/augment.cpp and held byte for byte
               against its plain version at the ukbb192 flagship's train batch
               (bs 128, 192^2, padding (9, 18), hflip 0.5, through
               ArrayDataset.batch) and a ragged batch with hflip 0, both timed;
               ops/s2d.py's s2d_conv against F.conv2d at a narrow ukbb192 conv
               (C 32 -> 8, 3x3, 192^2, bs 32) in float32 (TF32 off) and bf16,
               timed plain against stage-packed; a morphomnist float32 train
               step at bs 32 under utils/profiling.trace, whose trace
               tools/trace_ops_torch.py reads for K1's and K1-bwd's 20 kernels
               each, tools/device_time_torch.py's device ms a step and
               StepTimer over 5 steps; tools/mfu_torch.py at morphomnist bs
               256 (ms a step, FLOPs, MFU against the float32 peak)
With --tune-k2 it only times the float32 K2 kernel's best candidate launches
at every ukbb shape (tune_k2) and prints the fastest as a table. With
--phases it runs only the phases named (after device and build) and prints
no kernels or result line; `--phases K1,K1-bwd,K3,K4,K2` checks every kernel
against its plain version alone (tools/tpu_checks.py's counterpart).
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


def synth_obs(cfg, device, n=BS, seed=SEED):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    res = cfg.input_res
    obs = {
        "x": rng.uniform(-1, 1, (n, 1, res, res)),
        "thickness": rng.uniform(-0.8, 0.8, (n, 1)),
        "intensity": rng.uniform(-0.8, 0.8, (n, 1)),
        "digit": np.eye(10)[rng.integers(0, 10, n)],
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


# ---------------------------------------------------------------------------
# Slice 8: PGM training, the dense counterfactual, Colour-MNIST, SimpleVAE
# ---------------------------------------------------------------------------

# PGMConfig overrides of each training setup: sup_pgm and sup_aux at bs BS
# with the CLI's defaults; semi_sup at checkpoints/semisup_morpho's hparams
# and, for ChestPGM, checkpoints/semi_sup_mimic's
PGM_SETUPS = {
    "sup_pgm": dict(dataset="morphomnist", setup="sup_pgm", bs=BS),
    "sup_aux": dict(dataset="morphomnist", setup="sup_aux", bs=BS),
    "semi_sup": dict(dataset="morphomnist", setup="semi_sup", bs=64, lr=5e-4, sup_frac=0.1,
                     alpha=1e-3),
    "semi_sup_mimic": dict(dataset="mimic", setup="semi_sup", bs=32, lr=1e-3, sup_frac=0.1,
                           alpha=0.1, input_res=64),
}
# the labelled split's size: 10% of Morpho-MNIST's 60,000 training images;
# chip_smoke holds no MIMIC split, so 1,000 there
PGM_N_LABELLED = {"morphomnist": 6000, "mimic": 1000}
PGM_CLASSES = {"digit": 10, "colour": 10, "race": 3}


def pgm_batch(dataset, n, res, rng):
    """A PGM loader batch (concat_pa=False) of ``n`` from ``rng``: uint8
    NHWC x and each parent in the PGM's space."""
    import numpy as np

    out = {"x": rng.integers(0, 256, (n, res, res, 3 if dataset == "cmnist" else 1))
           .astype(np.uint8)}
    kinds = {"morphomnist": {"thickness": "continuous", "intensity": "continuous",
                             "digit": "categorical"},
             "mimic": {"sex": "binary", "age": "continuous", "race": "categorical",
                       "finding": "binary"}}[dataset]
    for k, kind in kinds.items():
        if kind == "categorical":
            out[k] = np.eye(PGM_CLASSES[k], dtype=np.float32)[rng.integers(0, PGM_CLASSES[k], n)]
        elif kind == "binary":
            out[k] = rng.integers(0, 2, (n, 1)).astype(np.float32)
        else:
            out[k] = rng.uniform(-0.8, 0.8, (n, 1)).astype(np.float32)
    return out


def guide_draws(model, n, rng):
    """The guide's draws of every site for ``n`` rows (CPU tensors): a
    standard normal (continuous), a uniform (binary), a standard Gumbel
    (categorical)."""
    import torch

    out = {}
    for k, kind in model.dag_variables.items():
        if kind == "categorical":
            out[k] = rng.gumbel(size=(n, PGM_CLASSES[k]))
        elif kind == "binary":
            out[k] = rng.uniform(0, 1, (n, 1))
        else:
            out[k] = rng.standard_normal((n, 1))
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}


def pgm_updates_card_vs_cpu(cfg, state, batches, draws):
    """Three updates of ``cfg.setup`` from ``state`` (the module's
    state_dict) on ``batches`` ((labelled, unlabelled) raw pairs) with the
    guide's ``draws``, each made on the card and on the CPU from the same
    parameters, EMA and AdamW moments (the card's copied from the CPU's
    before each), so that an update's parameters differ by at most 2 lr
    where a rounding-level gradient element takes another sign. Returns per
    update the metrics' rel errors, the largest parameter and EMA errors,
    and the card's metrics."""
    import copy

    import torch

    from causal_gen_tpu_torch.convert import build_pgm
    from causal_gen_tpu_torch.pgm.train_pgm import (init_pgm_state, preprocess_pgm_batch,
                                                    semi_sup_step, train_step)

    sts = {}
    for d in ("cpu", "cuda"):
        model = build_pgm(cfg.to_dict(), cfg.setup != "sup_pgm", torch.device(d))
        model.load_state_dict(state)
        sts[d] = init_pgm_state(cfg, model)
    out = []
    for raw_l, raw_u in batches:
        cpu, gpu = sts["cpu"], sts["cuda"]
        gpu.model.load_state_dict(cpu.model.state_dict())
        gpu.ema.load_state_dict(cpu.ema.state_dict())
        gpu.optimizer.load_state_dict(copy.deepcopy(cpu.optimizer.state_dict()))
        gpu.step = cpu.step
        ms = {}
        for key, st in sts.items():
            d = torch.device(key)
            b_l = preprocess_pgm_batch(cfg, raw_l, d)
            if cfg.setup == "semi_sup":
                m = semi_sup_step(cfg, st, b_l, preprocess_pgm_batch(cfg, raw_u, d),
                                  PGM_N_LABELLED[cfg.dataset],
                                  draws={k: v.to(d) for k, v in draws.items()})
            else:
                m = train_step(cfg, st, b_l)
            ms[key] = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        err = {w: max((getattr(gpu, w).state_dict()[k].cpu() - v).abs().max().item()
                      for k, v in getattr(cpu, w).state_dict().items()) for w in ("model", "ema")}
        out.append({"rel_err": rel_errs(ms["cuda"], ms["cpu"], list(ms["cpu"])),
                    "params_max_abs_err": err["model"], "ema_max_abs_err": err["ema"],
                    "card": ms["cuda"]})
    return out


def phase_pgm_train(names=("sup_pgm", "sup_aux", "semi_sup")):
    """PGM and predictor training (pgm/train_pgm.py) at the setups of
    PGM_SETUPS, weights and batches from the seed: three updates, each card
    against CPU from the same state with the same batches and guide draws
    (``pgm_updates_card_vs_cpu``: losses and site log-probs within 1e-4 rel,
    parameters and EMA within 2 lr); no kernel launched; the time of a step
    (median of 15) and the device's busy share under the profiler."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.convert import build_pgm
    from causal_gen_tpu_torch.pgm.train_pgm import (PGMConfig, init_pgm_state,
                                                    preprocess_pgm_batch, semi_sup_step,
                                                    train_step)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for name in names:
        cfg = PGMConfig(**PGM_SETUPS[name])
        semi = cfg.setup == "semi_sup"
        model = build_pgm(cfg.to_dict(), cfg.setup != "sup_pgm", dev,
                          generator=torch.Generator().manual_seed(SEED + 130))
        state = {k: v.cpu() for k, v in model.state_dict().items()}
        rng = np.random.default_rng(SEED + 131)
        batches = [(pgm_batch(cfg.dataset, cfg.bs, cfg.input_res, rng),
                    pgm_batch(cfg.dataset, cfg.bs, cfg.input_res, rng)) for _ in range(3)]
        draws = guide_draws(model, cfg.bs, rng)
        ups = pgm_updates_card_vs_cpu(cfg, state, batches, draws)
        worst = [max(v for k, v in u["rel_err"].items() if k != "grad_norm") for u in ups]
        perr = max(max(u["params_max_abs_err"], u["ema_max_abs_err"]) for u in ups)
        bound = 2 * cfg.lr + 1e-6
        if max(worst) > 1e-4 or perr > bound or \
                not all(math.isfinite(v) for u in ups for v in u["card"].values()):
            raise AssertionError(f"{name} card vs CPU: {ups} (parameter bound {bound:.2e})")
        res = out[name] = {"config": cfg.to_dict(), "updates": ups, "bound_2_lr": bound}
        losses = ", ".join(f"{u['card']['loss']:.6g}" for u in ups)
        log("pgm_train", f"{name} ({cfg.dataset}, bs {cfg.bs}): 3 updates, each card == CPU "
                         f"from the same state (TF32 off, the same batches and guide draws): "
                         f"losses and site log-probs rel {', '.join(f'{w:.2e}' for w in worst)}; "
                         f"grad norms rel {max(u['rel_err']['grad_norm'] for u in ups):.2e}; "
                         f"params and EMA {perr:.2e} (2 lr {bound:.1e}); card losses {losses}")

        # the path: counts set to 0 just before a step, read just after
        st = init_pgm_state(cfg, model)
        b_l, b_u = (preprocess_pgm_batch(cfg, b, dev) for b in batches[0])
        g = torch.Generator().manual_seed(SEED + 132)
        n_l = PGM_N_LABELLED[cfg.dataset]

        def step():
            if semi:
                return semi_sup_step(cfg, st, b_l, b_u, n_l, generator=g)
            return train_step(cfg, st, b_l)

        reset_counts()
        step()
        torch.cuda.synchronize()
        res["launches"] = read_counts()
        if any(res["launches"].values()):
            raise AssertionError(f"{name}: PGM training launched a kernel: {res['launches']}")
        for _ in range(3):
            step()
        times = []
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res["profile"] = profile_calls(step, 3, "step")
        ms = statistics.median(times)
        res.update({"step_ms": ms, "step_ms_all": times,
                    "samples_per_s": cfg.bs * (2 if semi else 1) / ms * 1e3})
        log("pgm_train", f"{name} step bs {cfg.bs}{' labelled + ' + str(cfg.bs) + ' unlabelled' if semi else ''}: "
                         f"median {ms:.3f} ms over 15 (min {min(times):.3f}, max "
                         f"{max(times):.3f}); no kernel launched")
    reset_counts()
    return out


DENSE_PATTERNS = ((), ("thickness",), ("intensity",), ("digit",), ("thickness", "intensity"))


def dense_do(obs, patterns, rng):
    """(do values of every parent, (B, 1) masks, each row's pattern): row i
    takes ``patterns[i % len]``; a value is another draw of the parent's
    kind (1 - x for a binary one, another one-hot, a uniform in [-0.8, 0.8])."""
    import numpy as np
    import torch

    n = obs["x"].shape[0]
    dev = obs["x"].device
    rows = [patterns[i % len(patterns)] for i in range(n)]
    values, masks = {}, {}
    for k, v in obs.items():
        if k == "x":
            continue
        if v.shape[1] > 1:
            new = np.eye(v.shape[1])[rng.integers(0, v.shape[1], n)]
        elif k in ("sex", "mri_seq", "finding"):
            new = 1.0 - v.cpu().numpy()
        else:
            new = rng.uniform(-0.8, 0.8, (n, 1))
        values[k] = torch.tensor(new, dtype=torch.float32, device=dev)
        masks[k] = torch.tensor([[float(k in r)] for r in rows], device=dev)
    return values, masks, rows


def phase_dense_cf(cfg):
    """DSCM.forward(do_mask=...) (counterfactual_dense): on the registry's
    morphomnist in float32 at bs BS with rows under DENSE_PATTERNS, the main
    path with K1's launch count (40, as the sparse forward), card against the
    CPU plain path with the noise injected (cf_x 1e-4, terms 1e-4 rel), the
    dense rows against the sparse forward of each pattern on the card, its
    time; then ukbb192 in bf16 at bs CHECK_BS under a mixed mask over the
    binary roots and the flows: K2 against its plain version at the path's
    shapes, the launches (K2 200, K1 80), card against CPU within the
    transfer's bound."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.ops.fused_block import fused_light_block, fused_light_block_ref

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dscm = build_slice(cfg, "cuda")
    obs = synth_obs(cfg, dev)
    rng = np.random.default_rng(SEED + 140)
    do, mask, rows = dense_do(obs, DENSE_PATTERNS, rng)
    n_sto = len(k1_res(cfg))
    g = torch.Generator().manual_seed(SEED + 141)
    out = {}
    with torch.inference_mode():
        reset_counts()
        r = dscm.forward(obs, do, generator=g, do_mask=mask)
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict(dict.fromkeys(counts, 0), fused_sample_kl=2 * n_sto)
        if counts != want or not torch.isfinite(r["cfs"]["x"]).all():
            raise AssertionError(f"dense DSCM.forward: launches {counts}, expected {want}")
        out["launches"] = counts
        noise = [e.to(dev) for e in normals(cfg, BS, rng, passes=2)]
        gpu = dscm.forward(obs, do, noise=noise, do_mask=mask)
        cpu_d = build_slice(cfg, "cpu", state=state_of(dscm.vae, dscm.pgm, dscm.predictor))
        cpu = cpu_d.forward({k: v.cpu() for k, v in obs.items()},
                            {k: v.cpu() for k, v in do.items()},
                            noise=[e.cpu() for e in noise],
                            do_mask={k: v.cpu() for k, v in mask.items()})
        err = (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs().max().item()
        pa_err = max((gpu["cfs"][k].cpu() - cpu["cfs"][k]).abs().max().item()
                     for k in do)
        rel = rel_errs(gpu, cpu, ("elbo", "nll", "kl", "aux_loss", "loss"))
        if err > 1e-4 or pa_err > 1e-5 or max(rel.values()) > 1e-4:
            raise AssertionError(f"dense card vs CPU: cf_x {err:.3e}, parents {pa_err:.3e}, {rel}")
        sparse_err = 0.0
        for pat in DENSE_PATTERNS:
            idx = [i for i, p in enumerate(rows) if p == pat]
            if not idx:
                continue
            sub = dscm.forward({k: v[idx] for k, v in obs.items()},
                               {k: do[k][idx] for k in pat}, noise=[e[idx] for e in noise])
            sparse_err = max(sparse_err, (sub["cfs"]["x"] - gpu["cfs"]["x"][idx]).abs().max()
                             .item(), *((sub["cfs"][k] - gpu["cfs"][k][idx]).abs().max().item()
                                        for k in do))
        if sparse_err > 1e-4:
            raise AssertionError(f"dense vs sparse on the card: max err {sparse_err:.3e}")
        out.update(card_vs_cpu={"cf_x_max_abs_err": err, "parents_max_abs_err": pa_err,
                                "rel_err": rel}, dense_vs_sparse_max_abs_err=sparse_err)
        log("dense_cf", f"morphomnist bs {BS}, rows under {[list(p) for p in DENSE_PATTERNS]}: "
                        f"K1 {counts['fused_sample_kl']} launches; card == CPU (TF32 off, noise "
                        f"injected): cf_x {err:.2e}, parents {pa_err:.2e}, terms rel "
                        f"{max(rel.values()):.2e}; dense == sparse per pattern on the card: "
                        f"{sparse_err:.2e}")
        for _ in range(3):
            dscm.forward(obs, do, generator=g, do_mask=mask)
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dscm.forward(obs, do, generator=g, do_mask=mask)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["profile"] = profile_calls(lambda: dscm.forward(obs, do, generator=g, do_mask=mask),
                                       3, "forward")
    ms = statistics.median(times)
    out.update(forward_ms=ms, forward_ms_all=times, cf_per_s=BS / ms * 1e3,
               k1_bound_ms_per_forward=k1_bounds(cfg, BS, 2)["k1_bound_ms_per_call"])
    log("dense_cf", f"morphomnist dense DSCM.forward bs {BS}: median {ms:.3f} ms over 20 (min "
                    f"{min(times):.3f}, max {max(times):.3f}) = {BS / ms * 1e3:.1f} cf/s")
    del dscm, cpu_d

    # ukbb192 in bf16 at bs CHECK_BS: the binary roots and K2 on the dense path
    c = ukbb_config("bfloat16", CHECK_BS)
    gpu_d = build_ukbb(c, "cuda")
    cpu_d = build_ukbb(c, "cpu", state_of(gpu_d.vae, gpu_d.pgm, gpu_d.predictor))
    enc_k2, dec_k2 = k2_cover(gpu_d.vae)
    k2_err = 0.0
    for (ch, cb, res_), _ in k2_blocks_by_shape(c, gpu_d.vae).items():
        args = k2_inputs(CHECK_BS, ch, cb, res_, res_, torch.bfloat16, True, dev, seed=SEED + 142)
        k2_err = max(k2_err, k2_compare(args, fused_light_block(*args),
                                        fused_light_block_ref(*args))[0])
    obs_c = ukbb_obs(c, CHECK_BS, torch.device("cpu"), seed=SEED + 143)
    pats = (("sex", "ventricle_volume"), ("mri_seq", "age"))
    do_c, mask_c, _ = dense_do(obs_c, pats, rng)
    noise = [torch.from_numpy(rng.standard_normal((CHECK_BS, c.z_dim, r, r)).astype(np.float32))
             for r in k1_res(c) * 2]
    n_sto = len(k1_res(c))
    with torch.inference_mode():
        reset_counts()
        gpu = gpu_d.forward({k: v.to(dev) for k, v in obs_c.items()},
                            {k: v.to(dev) for k, v in do_c.items()},
                            noise=[e.to(dev) for e in noise],
                            do_mask={k: v.to(dev) for k, v in mask_c.items()})
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict(dict.fromkeys(counts, 0), fused_sample_kl=2 * n_sto,
                    fused_light_block=2 * enc_k2 + 4 * dec_k2,
                    fused_light_block_tc=2 * enc_k2 + 4 * dec_k2)
        if counts != want:
            raise AssertionError(f"ukbb192 dense DSCM.forward: launches {counts}, expected {want}")
        cpu = cpu_d.forward(obs_c, do_c, noise=noise, do_mask=mask_c)
        err = (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs()
        bound = ukbb_transfer_bound(cpu_d, obs_c, cpu, noise[n_sto:])
        over = (err / bound).max().item()
        pa_err = max((gpu["cfs"][k].cpu() - cpu["cfs"][k]).abs().max().item() for k in do_c)
        rel = rel_errs(gpu, cpu, ("elbo", "nll", "kl", "aux_loss", "loss"))
        if over > 1 or pa_err > 1e-5 or max(rel[k] for k in ("elbo", "nll", "kl")) > 2e-2 \
                or max(rel[k] for k in ("aux_loss", "loss")) > 2.0 ** -4:
            raise AssertionError(f"ukbb192 dense card vs CPU: cf_x {over:.3f} of the bound, "
                                 f"parents {pa_err:.3e}, {rel}")
        # the masked parents took their do values, the others their observed ones
        for k in ("sex", "mri_seq"):
            want_k = torch.where(mask_c[k] > 0, do_c[k], obs_c[k])
            if not torch.equal(cpu["cfs"][k], want_k):
                raise AssertionError(f"ukbb192 dense: binary root {k} {cpu['cfs'][k]}")
    out["ukbb192"] = {"launches": counts, "k2_max_abs_err": k2_err,
                      "cf_x_err_over_bound": over, "cf_x_max_abs_err": err.max().item(),
                      "parents_max_abs_err": pa_err, "rel_err": rel}
    log("dense_cf", f"ukbb192 bf16 bs {CHECK_BS}, rows under {[list(p) for p in pats]}: K2 == "
                    f"plain version at the path's shapes (max err {k2_err:.3e}); launches K2 "
                    f"{counts['fused_light_block_tc']}, K1 {counts['fused_sample_kl']}; card == "
                    f"CPU: cf_x {over:.3f} of the transfer's bound, parents {pa_err:.1e}, "
                    + ", ".join(f"{k} rel {v:.2e}" for k, v in rel.items()))
    reset_counts()
    return out


def cmnist_config(bs=BS):
    """The registry's cmnist: checkpoints/cmnist/final_cmnist's configuration
    (widths 16-256, 32^2 RGB, diag_dgauss; tests/test_torch_cmnist_pgm.py
    holds the two equal)."""
    from causal_gen_tpu_torch.config import get_config

    return get_config("cmnist", bs=bs)


def build_cmnist(cfg, device, state=None):
    """A Colour-MNIST DSCM: the HVAE and ColourMNISTPGM as PGM and as
    predictor, weights from the seed or ``state``."""
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.pgm.dscm import DSCM
    from causal_gen_tpu_torch.pgm.flow_pgm import ColourMNISTPGM

    g = torch.Generator().manual_seed(SEED + 150)
    mods = (HVAE(cfg, device=device, generator=g),
            ColourMNISTPGM(setup_predictors=False, device=device, generator=g),
            ColourMNISTPGM(input_res=cfg.input_res, device=device, generator=g))
    if state is not None:
        for mod, sd in zip(mods, state):
            mod.load_state_dict(sd)
    return DSCM(cfg, mods[1], mods[2], mods[0])


def cmnist_obs(cfg, n, device, rng):
    import numpy as np
    import torch

    obs = {"x": rng.uniform(-1, 1, (n, 3, cfg.input_res, cfg.input_res)),
           "digit": np.eye(10)[rng.integers(0, 10, n)],
           "colour": np.eye(10)[rng.integers(0, 10, n)]}
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in obs.items()}


def phase_cmnist_cf():
    """DSCM.forward do(colour) on Colour-MNIST (final_cmnist's configuration,
    ColourMNISTPGM as PGM and predictor, seeded weights): K1 against its
    plain version at the path's shapes; the main path at bs BS under
    inference_mode with K1's launches; card against the CPU plain path at bs
    CHECK_BS with the noise injected (cf_x 1e-4, terms 1e-4 rel); its time."""
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = cmnist_config()
    out = {"k1_max_abs_err": k1_check(k1_shapes(cfg), torch.Generator().manual_seed(SEED + 151))}
    dscm = build_cmnist(cfg, "cuda")
    rng = np.random.default_rng(SEED + 152)
    obs = cmnist_obs(cfg, BS, dev, rng)
    do = {"colour": torch.tensor(np.eye(10)[rng.integers(0, 10, BS)], dtype=torch.float32,
                                 device=dev)}
    n_sto = len(k1_res(cfg))
    g = torch.Generator().manual_seed(SEED + 153)
    with torch.inference_mode():
        reset_counts()
        r = dscm.forward(obs, do, generator=g)
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict(dict.fromkeys(counts, 0), fused_sample_kl=2 * n_sto)
        if counts != want or not torch.isfinite(r["cfs"]["x"]).all() or \
                not torch.equal(r["cfs"]["colour"], do["colour"]) or \
                not torch.equal(r["cfs"]["digit"], obs["digit"]):
            raise AssertionError(f"cmnist DSCM.forward: launches {counts}, expected {want}")
        out["launches"] = counts
        c = cmnist_config(CHECK_BS)
        state = state_of(dscm.vae, dscm.pgm, dscm.predictor)
        cpu_d = build_cmnist(c, "cpu", state)
        obs_c = {k: v[:CHECK_BS].cpu() for k, v in obs.items()}
        do_c = {k: v[:CHECK_BS].cpu() for k, v in do.items()}
        noise = normals(c, CHECK_BS, rng, passes=2)
        gpu = build_cmnist(c, "cuda", state).forward(
            {k: v.to(dev) for k, v in obs_c.items()}, {k: v.to(dev) for k, v in do_c.items()},
            noise=[e.to(dev) for e in noise])
        cpu = cpu_d.forward(obs_c, do_c, noise=noise)
        err = (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs().max().item()
        rel = rel_errs(gpu, cpu, ("elbo", "nll", "kl", "aux_loss", "loss"))
        if err > 1e-4 or max(rel.values()) > 1e-4:
            raise AssertionError(f"cmnist card vs CPU: cf_x {err:.3e}, {rel}")
        out["card_vs_cpu"] = {"cf_x_max_abs_err": err, "rel_err": rel}
        log("cmnist_cf", f"K1 == plain version at {k1_shapes(cfg)} (max err "
                         f"{out['k1_max_abs_err']:.2e}); main path do(colour) bs {BS}: K1 "
                         f"{counts['fused_sample_kl']} launches; bs {CHECK_BS} card == CPU (TF32 "
                         f"off, noise injected): cf_x {err:.2e}, terms rel {max(rel.values()):.2e}")
        times = forward_times(dscm, obs, do, g)
        out["profile"] = profile_calls(lambda: dscm.forward(obs, do, generator=g), 3, "forward")
    ms = statistics.median(times)
    out.update(forward_ms=ms, forward_ms_all=times, cf_per_s=BS / ms * 1e3,
               k1_bound_ms_per_forward=k1_bounds(cfg, BS, 2)["k1_bound_ms_per_call"])
    log("cmnist_cf", f"cmnist DSCM.forward do(colour) bs {BS}: median {ms:.3f} ms over 20 (min "
                     f"{min(times):.3f}, max {max(times):.3f}) = {BS / ms * 1e3:.1f} cf/s")
    reset_counts()
    return out


def simple_config(cond_prior, bs=BS):
    """The registry's morphomnist with the simple VAE and its logit-Normal
    head (diag_gauss), cond_prior off or on."""
    from causal_gen_tpu_torch.config import get_config

    return get_config("morphomnist", bs=bs, vae="simple", x_like="diag_gauss",
                      cond_prior=cond_prior)


def build_simple(cfg, device, state=None):
    """A Morpho-MNIST DSCM (``build_slice``'s PGMs) with SimpleVAE as the
    image mechanism, weights from the seed or ``state``."""
    import torch

    from causal_gen_tpu_torch.models.simple_vae import SimpleVAE
    from causal_gen_tpu_torch.pgm.dscm import DSCM
    from causal_gen_tpu_torch.pgm.flow_pgm import MorphoMNISTPGM

    g = torch.Generator().manual_seed(SEED + 160)
    mods = (SimpleVAE(cfg, device=device, generator=g),
            MorphoMNISTPGM(setup_predictors=False, device=device, generator=g),
            MorphoMNISTPGM(input_res=cfg.input_res, device=device, generator=g))
    if state is not None:
        for mod, sd in zip(mods, state):
            mod.load_state_dict(sd)
    elif cfg.cond_prior:  # the zero-initialised prior heads would hide the parents
        fill_zero_leaves(mods[0], torch.Generator().manual_seed(SEED + 161))
    return DSCM(cfg, mods[1], mods[2], mods[0], elbo_constraint=1.8)


def simple_draws(cfg, n, rng, kind):
    """CPU draws of the simple VAE: the latent's normal (n, z_dim), then the
    head's: GaussNet's dequantisation uniforms ("nll") or its normal
    ("sample"), of the image's shape."""
    import numpy as np
    import torch

    res = cfg.input_res
    head = (rng.uniform(0, 1, (n, 1, res, res)) if kind == "nll"
            else rng.standard_normal((n, 1, res, res)))
    return [torch.from_numpy(rng.standard_normal((n, cfg.z_dim)).astype(np.float32)),
            torch.from_numpy(head.astype(np.float32))]


def phase_simple_vae():
    """SimpleVAE + GaussNet (diag_gauss) on morphomnist with cond_prior off and
    on, seeded weights: three train steps card against the CPU plain path
    with the draws and (cond_prior) the dropout options 0, 1, 2 injected
    (metrics 1e-4 rel, parameters within 2 sum(lr)); DSCM.forward do(thickness)
    at bs BS card against CPU (cf_x 1e-4, terms 1e-4 rel) and its time;
    sample(return_loc=False, t=0.7) card against CPU (1e-4) and its time; no
    kernel launched on any of them."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import to_device, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu_dev = torch.device("cuda"), torch.device("cpu")
    out = {}
    for cp in (False, True):
        cfg = simple_config(cp)
        name = "cond_prior" if cp else "plain"
        res = out[name] = {}
        dscm = build_simple(cfg, "cuda")
        state = state_of(dscm.vae, dscm.pgm, dscm.predictor)
        rng = np.random.default_rng(SEED + 162)
        batches = [synth_batch(cfg, rng) for _ in range(3)]
        draws = [([torch.tensor(s)] if cp else []) + simple_draws(cfg, BS, rng, "nll")
                 for s in range(3)]
        ms, sts, lrs = {}, {}, []
        for key, d in (("cpu", cpu_dev), ("cuda", dev)):
            st = sts[key] = init_train_state(cfg, build_simple(cfg, d, state).vae)
            ms[key] = []
            for b, dr in zip(batches, draws):
                if key == "cpu":
                    lrs.append(st.optimizer.param_groups[0]["lr"])
                r = train_step(cfg, st, to_device(b, d), noise=[[e.to(d) for e in dr]])
                ms[key].append({k: float(v) for k, v in r.items()})
        rel = [rel_errs(g, c, ("elbo", "nll", "kl", "grad_norm"))
               for g, c in zip(ms["cuda"], ms["cpu"])]
        perr = max((sts["cuda"].model.state_dict()[k].cpu() - v).abs().max().item()
                   for k, v in sts["cpu"].model.state_dict().items())
        bound = 2 * sum(lrs) + 1e-6
        if max(max(r.values()) for r in rel) > 1e-4 or perr > bound or \
                any(m["skipped"] for m in ms["cuda"]):
            raise AssertionError(f"simple VAE {name} train card vs CPU: {rel}, params {perr:.3e} "
                                 f"(bound {bound:.3e})")
        res["train_card_vs_cpu"] = {"rel_err_by_update": rel, "params_max_abs_err": perr,
                                    "bound_2_sum_lr": bound}

        obs = synth_obs(cfg, dev)
        do = {"thickness": torch.full((BS, 1), 0.5, device=dev)}
        g = torch.Generator().manual_seed(SEED + 163)
        pa = torch.cat([obs["thickness"], obs["intensity"], obs["digit"]], dim=1)
        with torch.inference_mode():
            noise = simple_draws(cfg, BS, rng, "nll") + simple_draws(cfg, BS, rng, "nll")[:1]
            cpu_d = build_simple(cfg, "cpu", state)
            gpu = dscm.forward(obs, do, noise=[e.to(dev) for e in noise])
            cpu = cpu_d.forward({k: v.cpu() for k, v in obs.items()},
                                {k: v.cpu() for k, v in do.items()}, noise=noise)
            err = (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs().max().item()
            rel_f = rel_errs(gpu, cpu, ("elbo", "nll", "kl", "aux_loss", "loss"))
            sd = simple_draws(cfg, BS, rng, "sample")
            sx, _ = dscm.vae.sample(pa, False, 0.7, noise=iter([e.to(dev) for e in sd]))
            cx, _ = cpu_d.vae.sample(pa.cpu(), False, 0.7, noise=iter(sd))
            s_err = (sx.cpu() - cx).abs().max().item()
            if err > 1e-4 or max(rel_f.values()) > 1e-4 or s_err > 1e-4:
                raise AssertionError(f"simple VAE {name} card vs CPU: cf_x {err:.3e}, {rel_f}, "
                                     f"sample {s_err:.3e}")
            res["forward_card_vs_cpu"] = {"cf_x_max_abs_err": err, "rel_err": rel_f}
            res["sample_max_abs_err"] = s_err
            reset_counts()
            dscm.forward(obs, do, generator=g)
            dscm.vae.sample(pa, False, 0.7, generator=g)
            torch.cuda.synchronize()
            res["launches"] = read_counts()
            if any(res["launches"].values()):
                raise AssertionError(f"simple VAE {name}: a kernel launched {res['launches']}")
            times = forward_times(dscm, obs, do, g)
            for _ in range(3):
                dscm.vae.sample(pa, False, 0.7, generator=g)
            s_times = []
            for _ in range(15):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dscm.vae.sample(pa, False, 0.7, generator=g)
                torch.cuda.synchronize()
                s_times.append((time.perf_counter() - t0) * 1e3)
            res["profile_forward"] = profile_calls(lambda: dscm.forward(obs, do, generator=g),
                                                   3, "forward")
        fwd, smp = statistics.median(times), statistics.median(s_times)
        res.update(forward_ms=fwd, forward_ms_all=times, cf_per_s=BS / fwd * 1e3,
                   sample_ms=smp, sample_ms_all=s_times, samples_per_s=BS / smp * 1e3)
        log("simple_vae", f"{name}: 3 train steps card == CPU (TF32 off, draws injected"
                          f"{', options 0/1/2' if cp else ''}): metrics rel "
                          f"{max(max(r.values()) for r in rel):.2e}, params {perr:.2e} (2 sum(lr) "
                          f"{bound:.1e}); DSCM.forward bs {BS} cf_x {err:.2e}, terms rel "
                          f"{max(rel_f.values()):.2e}; sample t=0.7 {s_err:.2e}; no kernel "
                          f"launched; forward median {fwd:.3f} ms ({BS / fwd * 1e3:.1f} cf/s), "
                          f"sample median {smp:.3f} ms ({BS / smp * 1e3:.1f} images/s)")
    reset_counts()
    return out


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
        elif k == "race":  # MIMIC's one-hot of 3
            cols.append(np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])
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
        # the viz callback is held in phase viz; its early cadence would draw here
        argv = ["--hps", cfg.name, "--device", "cuda", "--epochs", "2", "--eval_freq", "2",
                "--bs", str(BS), "--max_batches", str(n_batches), "--save_dir", save_dir,
                "--viz_freq", "0"]
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
        if saved_cfg != cfg.replace(epochs=2, eval_freq=2, viz_freq=0) or extra.get("epoch") != 2:
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


# ---------------------------------------------------------------------------
# Slice 9: counterfactual fine-tuning (stage 3) and its evaluation
# ---------------------------------------------------------------------------

# the CFConfig fields of the flagships' CF runs
# (checkpoints/{ukbb192,mimic192}_flagship/cf/checkpoint.meta.json) and of
# checkpoints/cf_morphomnist/final_cf_morph_tw25; grad_clip 350, the EMA
# and lr 1e-4 are CFConfig's defaults there too
CF_CONFIGS = {
    "ukbb192": dict(bs=16, beta=5.0, lr=1e-4, lr_lagrange=1e-2, alpha=0.1, wd=0.05,
                    betas=(0.9, 0.9), elbo_constraint=2.3868378400802612, damping=100.0),
    "mimic192": dict(bs=16, beta=9.0, lr=1e-4, lr_lagrange=1e-2, alpha=0.1, wd=0.1,
                     betas=(0.9, 0.9), elbo_constraint=3.0605525970458984, damping=100.0),
    "morphomnist": dict(bs=32, beta=1.0, lr=1e-4, lr_lagrange=1e-2, wd=0.01, betas=(0.9, 0.9),
                        elbo_constraint=0.5131167785644531, thickness_weight=2.5,
                        intensity_weight=0.05,
                        thickness_calib=(1.2231597663423281, 0.5294727873345971)),
}
CF_TIMED = 6  # updates a timed path's median is taken over (10 before the parallel
# phase was added: cut to keep the whole run well inside DEADLINE_S)


def cf_config(name, **overrides):
    """The CF run's configuration of ``name``. Seeded weights lie far from a
    trained model's ELBO, where every update of the flagship's grad_skip 500
    would be skipped: the timed and the checked paths lift it so that each
    update is made (a skipped one costs the same forward and backward)."""
    from causal_gen_tpu_torch.pgm.train_cf import CFConfig

    return CFConfig(**{**CF_CONFIGS[name], "grad_skip": 1e30, **overrides})


def cf_dscm(name, cf, device, dtype="bfloat16", bs=None, state=None, remat=False):
    """The DSCM of a CF path with its CF configuration's Lagrangian, the
    soft-morphometry terms and ``remat``: ukbb192 (UKBB FlowPGM), the
    mimic192 flagship's (ChestPGM) or the registry's morphomnist (float32)."""
    from causal_gen_tpu_torch.config import get_config

    if name == "ukbb192":
        d = build_ukbb(ukbb_config(dtype, bs or cf.bs), device, state)
    elif name == "mimic192":
        d = build_mimic(mimic_config(dtype, bs or cf.bs), device, state)
    else:
        d = build_slice(get_config("morphomnist", bs=bs or cf.bs), device, state)
    d.elbo_constraint, d.damping, d.remat = cf.elbo_constraint, cf.damping, remat
    d.thickness_weight, d.intensity_weight = cf.thickness_weight, cf.intensity_weight
    d.thickness_calib = tuple(cf.thickness_calib)
    return d


def cf_obs(name, cfg, n, device, seed):
    obs = {"ukbb192": ukbb_obs, "mimic192": mimic_obs, "morphomnist": synth_obs}[name]
    return obs(cfg, device=device, n=n, seed=seed)


def cf_sync(dst, src):
    """The CF state ``dst`` (on its device) takes ``src``'s parameters, λ,
    EMA, both optimizers' states and counters."""
    import copy

    from causal_gen_tpu_torch.pgm.train_cf import cf_state_payload, restore_cf_state

    payload = cf_state_payload(src)
    payload["opt_state"] = copy.deepcopy(payload["opt_state"])
    payload["lagrange_opt_state"] = copy.deepcopy(payload["lagrange_opt_state"])
    restore_cf_state(dst, payload)


def cf_updates_card_vs_cpu(name, cf, n_updates, bs, seed):
    """``n_updates`` CF updates in float32 (TF32 off), each made on the card
    and on the CPU from one state (the card's synced from the CPU's before
    each) with the same batch, dense intervention and posterior draws:
    the forward's scalars within 1e-4 rel, λ within 1e-5 abs + rel, the
    parameters and their EMA within 2 lr. Returns each update's errors."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.pgm.train_cf import (TERMS, cf_train_step, dense_intervention,
                                                    init_cf_state, random_intervention)

    cpu_d = cf_dscm(name, cf, "cpu", "float32", bs)
    gpu_d = cf_dscm(name, cf, "cuda", "float32", bs,
                    state=state_of(cpu_d.vae, cpu_d.pgm, cpu_d.predictor))
    sts = {"cpu": init_cf_state(cf, cpu_d), "cuda": init_cf_state(cf, gpu_d)}
    rng = np.random.default_rng(seed)
    dag = tuple(cpu_d.pgm.dag_variables)
    out = []
    for u in range(n_updates):
        cf_sync(sts["cuda"], sts["cpu"])
        obs = cf_obs(name, cpu_d.cfg, bs, torch.device("cpu"), seed + 1 + u)
        do, mask = dense_intervention(dag, obs, random_intervention(rng, dag, obs))
        noise = normals(cpu_d.cfg, bs, rng, passes=2)
        ms = {}
        for d, st in sts.items():
            dv = torch.device(d)
            m = cf_train_step(cf, st, {k: v.to(dv) for k, v in obs.items()},
                              {k: v.to(dv) for k, v in do.items()},
                              {k: v.to(dv) for k, v in mask.items()},
                              noise=[[e.to(dv) for e in noise]])
            ms[d] = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        cpu, gpu = sts["cpu"], sts["cuda"]
        rel = rel_errs(ms["cuda"], ms["cpu"], [k for k in TERMS if ms["cpu"][k] != 0.0])
        lm = max(abs(gpu.dscm.lmbda.item() - cpu.dscm.lmbda.item()),
                 abs(gpu.ema.lmbda.item() - cpu.ema.lmbda.item()))
        perr = max((b.cpu() - a).abs().max().item() for w in ("dscm", "ema")
                   for a, b in zip(getattr(cpu, w).vae.state_dict().values(),
                                   getattr(gpu, w).vae.state_dict().values()))
        bound = 2 * cf.lr + 1e-6
        if max(rel.values()) > 1e-4 or lm > 1e-5 * (1 + abs(cpu.dscm.lmbda.item())) \
                or perr > bound or ms["cuda"]["skipped"] or ms["cpu"]["skipped"]:
            raise AssertionError(f"{name} CF update {u} card vs CPU: {ms}, rel {rel}, lmbda "
                                 f"{lm:.2e}, params {perr:.2e} (2 lr {bound:.1e})")
        out.append({"rel_err": rel, "lmbda_abs_err": lm, "params_ema_max_abs_err": perr,
                    "grad_norm_rel_err": rel_errs(ms["cuda"], ms["cpu"], ["grad_norm"]),
                    "card": ms["cuda"]})
    return out


def cf_remat_grads(name, cf, bs, seed, d=None):
    """Forward and backward of one CF loss on the card with remat off and
    on, the same generator seed (K1's Philox seeds and every draw come from
    it), deterministic algorithms: the loss and every gradient (the VAE's and
    λ's) within 1e-6 of the tensor's largest magnitude, and the generator
    left in the same state. ``d`` is the DSCM to use (else one is built).
    Returns the largest relative error."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.pgm.train_cf import dense_intervention, random_intervention

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)  # index_add's sorted backward
    try:
        d = d or cf_dscm(name, cf, "cuda", bs=bs)
        obs = cf_obs(name, d.cfg, bs, torch.device("cuda"), seed)
        dag = tuple(d.pgm.dag_variables)
        do, mask = dense_intervention(dag, obs, random_intervention(
            np.random.default_rng(seed), dag, obs))
        runs = []
        for remat in (False, True):
            d.remat = remat
            params = list(d.vae.parameters()) + [d.lmbda]
            for p in params:
                p.grad = None
            g = torch.Generator().manual_seed(seed)
            reset_counts()
            out = d.forward(obs, do, do_mask=mask, beta=cf.beta, generator=g)
            out["loss"].backward()
            torch.cuda.synchronize()
            runs.append((out["loss"].item(), [torch.zeros_like(p) if p.grad is None
                                              else p.grad.clone() for p in params],
                         g.get_state(), read_counts()))
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    (l0, g0, s0, c0), (l1, g1, s1, c1) = runs
    rel = max([abs(l1 - l0) / abs(l0)] + [((b - a).abs().max() / a.abs().max().clamp(
        min=1e-30)).item() for a, b in zip(g0, g1)])
    if rel > 1e-6 or not torch.equal(s0, s1):
        raise AssertionError(f"{name} remat on vs off on the card: rel err {rel:.3e}, the "
                             f"generator's state {'the same' if torch.equal(s0, s1) else 'differs'}")
    return {"max_rel_err": rel, "launches_off": c0, "launches_on": c1}


def cf_timed_update(name, cf, remat, seed, d=None, profile=True):
    """The main path of a CF update at ``cf.bs``: a random single-parent
    dense intervention from the batch, then ``cf_train_step``, with the launch
    counts read around one update (K1 and K1-bwd on each posterior pass; with
    remat K1 runs again in each recompute); the median of CF_TIMED updates
    on the host clock, the peak memory and (``profile``) the profiler's
    device share. ``d`` is the DSCM to use (else one is built)."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.pgm.train_cf import (cf_train_step, dense_intervention,
                                                    init_cf_state, random_intervention)

    d = d or cf_dscm(name, cf, "cuda")
    d.remat = remat
    st = init_cf_state(cf, d)
    obs = cf_obs(name, d.cfg, cf.bs, torch.device("cuda"), seed)
    host = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    dag = tuple(d.pgm.dag_variables)

    def update():
        do, mask = dense_intervention(dag, obs, random_intervention(host, dag, obs))
        return cf_train_step(cf, st, obs, do, mask, generator=g)

    n_sto = len(k1_res(d.cfg))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    m = update()
    torch.cuda.synchronize()
    counts = read_counts()
    want = dict(dict.fromkeys(counts, 0), fused_sample_kl=(4 if remat else 2) * n_sto,
                fused_sample_kl_bwd=2 * n_sto)
    if counts != want or not math.isfinite(float(m["loss"])) or m["skipped"]:
        raise AssertionError(f"{name} CF update (remat {remat}): launches {counts}, expected "
                             f"{want}; {m}")
    for _ in range(2):
        update()
    times = []
    for _ in range(CF_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(times)
    out = {"launches": counts, "update_ms": ms, "update_ms_all": times,
           "cf_samples_per_s": cf.bs / ms * 1e3, "peak_mem_gb": peak,
           "metrics_first": {k: float(v) for k, v in m.items()}, "steps": st.step}
    log("cf_train", f"{name} CF update bs {cf.bs}{' remat' if remat else ''}: launches K1 "
                    f"{counts['fused_sample_kl']} + K1-bwd {counts['fused_sample_kl_bwd']}; "
                    f"median {ms:.3f} ms over {CF_TIMED} (min {min(times):.3f}, max "
                    f"{max(times):.3f}) = {out['cf_samples_per_s']:.1f} CF samples/s; peak "
                    f"memory {peak:.2f} GB; first loss {float(m['loss']):.4g}, grad_norm "
                    f"{float(m['grad_norm']):.4g}")
    # one update: the profiler's processing of its ~33,000-45,000 events
    # takes tens of seconds a call
    if profile:
        out["profile"] = profile_calls(update, 1, "update")
    d.remat = False
    return out


def cf_eval_path(cf, seed, d=None, profile=True):
    """The ukbb192 CF eval step (pgm/train_cf.py::make_cf_eval_step: the
    EMA's DSCM.forward and the predictor on the counterfactuals, under
    inference_mode) at cf.bs under a random single-parent intervention: K2
    on every covered block of the 2 encoder and 4 decoder passes, K1 on the
    2 posterior passes; its time. ``d`` is the DSCM to use (else one is
    built)."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.pgm.train_cf import (init_cf_state, make_cf_eval_step,
                                                    random_intervention)

    d = d or cf_dscm("ukbb192", cf, "cuda")
    st = init_cf_state(cf, d)
    step = make_cf_eval_step(cf, st.ema)
    obs = cf_obs("ukbb192", d.cfg, cf.bs, torch.device("cuda"), seed)
    host = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    dag = tuple(d.pgm.dag_variables)
    enc_k2, dec_k2 = k2_cover(d.vae)

    def run():
        return step(obs, random_intervention(host, dag, obs), generator=g)

    reset_counts()
    m, preds, cfs = run()
    torch.cuda.synchronize()
    counts = read_counts()
    k2 = 2 * enc_k2 + 4 * dec_k2
    want = dict(dict.fromkeys(counts, 0), fused_sample_kl=2 * len(k1_res(d.cfg)),
                fused_light_block=k2, fused_light_block_tc=k2)
    if counts != want or not torch.isfinite(cfs["x"]).all() or \
            not all(torch.isfinite(v).all() for v in preds.values()):
        raise AssertionError(f"ukbb192 CF eval step: launches {counts}, expected {want}")
    for _ in range(2):
        run()
    times = []
    for _ in range(CF_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    log("cf_train", f"ukbb192 CF eval step bs {cf.bs} (inference_mode): launches K2 "
                    f"{counts['fused_light_block_tc']}, K1 {counts['fused_sample_kl']}; median "
                    f"{ms:.3f} ms over {CF_TIMED} (min {min(times):.3f}, max {max(times):.3f})")
    return {"launches": counts, "eval_ms": ms, "eval_ms_all": times,
            **({"profile": profile_calls(run, 1, "eval")} if profile else {})}


def cf_datasets(n_train, n_valid, seed):
    """Morpho-MNIST-like ArrayDatasets for the CF CLI: a bright bar of a
    random width on a dark 32^2 image, thickness and intensity in [-1, 1],
    a digit one-hot."""
    import numpy as np

    from causal_gen_tpu_torch.data.datasets import ArrayDataset

    rng = np.random.default_rng(seed)

    def build(n):
        x = np.zeros((n, 32, 32, 1), np.uint8)
        for i in range(n):
            w = int(rng.integers(2, 7))
            x[i, 8:24, 16 - w // 2: 16 - w // 2 + w] = rng.integers(150, 256)
        return ArrayDataset(images=x, attrs={
            "thickness": rng.uniform(-1, 1, n).astype(np.float32),
            "intensity": rng.uniform(-1, 1, n).astype(np.float32),
            "digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]},
            columns=("thickness", "intensity", "digit"))

    return {"train": build(n_train), "valid": build(n_valid)}


def cf_cli_run(save_dir, cf):
    """cli.train_cf on the card from seeded morphomnist mechanisms written as
    the port's checkpoints: 1 epoch of 2 updates with the valid sweeps and the
    counterfactual panel, then --resume for a second; the launches of the
    first run against the path's (K1 on each update's 2 passes, each sweep
    batch's 2 and the panel's 2, K1-bwd on each update's)."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.cli import train_cf as cli
    from causal_gen_tpu_torch.config import get_config
    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.pgm.flow_pgm import MorphoMNISTPGM
    from causal_gen_tpu_torch.pgm.train_pgm import PGMConfig, init_pgm_state, save_pgm_checkpoint
    from causal_gen_tpu_torch.train.checkpoint import state_payload, write_payload
    from causal_gen_tpu_torch.train.state import init_train_state

    cfg = get_config("morphomnist", bs=cf.bs)
    g = torch.Generator().manual_seed(SEED + 160)
    paths = {r: os.path.join(save_dir, r, "checkpoint") for r in ("vae", "pgm", "aux")}
    for p in paths.values():
        os.makedirs(os.path.dirname(p), exist_ok=True)
    write_payload(paths["vae"], state_payload(init_train_state(cfg, HVAE(cfg, "cuda", g))),
                  {"config": cfg.to_dict(), "extra": {"best_loss": cf.elbo_constraint}})
    for role, setup in (("pgm", "sup_pgm"), ("aux", "sup_aux")):
        pcfg = PGMConfig(setup=setup)
        mod = MorphoMNISTPGM(setup_predictors=setup == "sup_aux", device="cuda", generator=g)
        save_pgm_checkpoint(paths[role], pcfg, init_pgm_state(pcfg, mod))
    n_batches, n_sto = 2, len(k1_res(cfg))
    ds = cf_datasets(n_batches * cf.bs, n_batches * cf.bs, SEED + 161)
    out_dir = os.path.join(save_dir, "cf")
    argv = ["--pgm_path", paths["pgm"], "--predictor_path", paths["aux"], "--vae_path",
            paths["vae"], "--device", "cuda", "--bs", str(cf.bs), "--max_batches",
            str(n_batches), "--save_dir", out_dir, "--thickness_weight",
            str(cf.thickness_weight), "--intensity_weight", str(cf.intensity_weight),
            "--wd", str(cf.wd), "--calib_n", "64"]
    reset_counts()
    t0 = time.perf_counter()
    state, hist = cli.main(argv + ["--epochs", "1"], datasets=ds)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    sweeps = len(state.dscm.pgm.dag_variables) + 1
    # the panel after the sweeps is one more eval forward (cf_particles 1)
    want = dict(dict.fromkeys(counts, 0),
                fused_sample_kl=2 * n_sto * (n_batches * (1 + sweeps) + 1),
                fused_sample_kl_bwd=2 * n_sto * n_batches)
    if counts != want or state.step + state.skipped != n_batches or \
            not all(math.isfinite(v) for v in hist.values()):
        raise AssertionError(f"cli.train_cf: launches {counts}, expected {want}; {hist}")
    state2, _ = cli.main(argv + ["--epochs", "2", "--resume", os.path.join(out_dir, "checkpoint")],
                         datasets=ds)
    if state2.step + state2.skipped != 2 * n_batches:
        raise AssertionError(f"cli.train_cf --resume: {state2.step} updates, {state2.skipped} "
                             f"skipped after 2 epochs")
    log("cf_train", f"cli.train_cf morphomnist bs {cf.bs} on the card: 1 epoch x {n_batches} "
                    f"updates + {sweeps} valid sweeps in {secs:.1f} s, launches {counts}; "
                    f"--resume took epoch 2 ({state2.step} made, {state2.skipped} skipped); "
                    f"random-do valid loss {hist['valid_do_None/loss']:.4g}")
    return {"seconds": secs, "launches": counts, "history": hist}


def phase_cf_train():
    """Counterfactual fine-tuning (pgm/train_cf.py) and its eval step on the
    card: the ukbb192 flagship's CF configuration (bf16, bs 16) with and
    without remat, its eval step, the mimic192 flagship's and
    final_cf_morph_tw25's (morphomnist with the soft-morphometry terms, bs
    32) updates; card against the CPU plain path (float32, TF32 off, each
    update from one state: ukbb192 at bs CHECK_BS once, morphomnist twice);
    remat on against off on the card; cli.train_cf with a resume."""
    import tempfile

    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"configs": {k: cf_config(k).to_dict() for k in CF_CONFIGS}, "seconds": {}}
    t0 = time.perf_counter()

    def lap(part):  # the phase's seconds by part, for the run's time budget
        out["seconds"][part] = time.perf_counter() - t0 - sum(out["seconds"].values())

    ukbb, mimic, morph = (cf_config(k) for k in ("ukbb192", "mimic192", "morphomnist"))
    # K1 and K1-bwd at the CF paths' shapes (morphomnist's are phase K1's)
    shapes = sorted({(cf.bs, c.z_dim, r, r) for cf, c in ((ukbb, ukbb_config(bs=ukbb.bs)),
                                                          (mimic, mimic_config(bs=mimic.bs)))
                     for r in k1_res(c)})
    g = torch.Generator().manual_seed(SEED + 158)
    out.update(k1_shapes=shapes, k1_max_abs_err=k1_check(shapes, g),
               k1_bwd_max_abs_err=k1_bwd_check(shapes, g))
    lap("K1 checks")
    log("cf_train", f"K1 == plain version (max err {out['k1_max_abs_err']:.2e}) and K1-bwd == "
                    f"autograd of it (max err {out['k1_bwd_max_abs_err']:.2e}) at the ukbb192 "
                    f"and mimic192 CF updates' {len(shapes)} shapes, bs 16")
    out["card_vs_cpu"] = {"ukbb192": cf_updates_card_vs_cpu("ukbb192", ukbb, 1, CHECK_BS,
                                                            SEED + 150),
                          "morphomnist": cf_updates_card_vs_cpu("morphomnist", morph, 2, 8,
                                                                SEED + 151)}
    lap("card vs CPU")
    for k, ups in out["card_vs_cpu"].items():
        log("cf_train", f"{k} float32 CF updates card == CPU from one state each (TF32 off, the "
                        f"same batch, intervention and draws): terms rel "
                        + ", ".join(f"{max(u['rel_err'].values()):.2e}" for u in ups)
                        + "; lmbda " + ", ".join(f"{u['lmbda_abs_err']:.1e}" for u in ups)
                        + "; params and EMA " + ", ".join(f"{u['params_ema_max_abs_err']:.1e}"
                                                          for u in ups)
                        + f" (2 lr {2 * CF_CONFIGS[k]['lr']:.0e})")
    # one seeded ukbb192 DSCM serves its paths, its weights restored before each
    uk_d = cf_dscm("ukbb192", ukbb, "cuda")
    uk_init = {k: v.detach().clone() for k, v in uk_d.vae.state_dict().items()}

    def ukbb_dscm():
        uk_d.vae.load_state_dict(uk_init)
        return uk_d

    out["remat_grads"] = {"morphomnist": cf_remat_grads("morphomnist", morph, BS, SEED + 152),
                          "ukbb192": cf_remat_grads("ukbb192", ukbb, CHECK_BS, SEED + 153,
                                                    ukbb_dscm())}
    log("cf_train", "remat on == off on the card (same generator seed, deterministic "
                    "algorithms): "
                    + ", ".join(f"{k} max rel err {v['max_rel_err']:.1e} (K1 "
                                f"{v['launches_off']['fused_sample_kl']} -> "
                                f"{v['launches_on']['fused_sample_kl']})"
                                for k, v in out["remat_grads"].items()))
    lap("remat grads")
    out["ukbb192"] = cf_timed_update("ukbb192", ukbb, False, SEED + 154, ukbb_dscm())
    # only the flagship's plain update is profiled: each profile takes tens
    # of seconds, and the run must end inside DEADLINE_S
    out["ukbb192_remat"] = cf_timed_update("ukbb192", ukbb, True, SEED + 154, ukbb_dscm(),
                                           profile=False)
    out["ukbb192_eval"] = cf_eval_path(ukbb, SEED + 155, ukbb_dscm(), profile=False)
    del uk_d
    torch.cuda.empty_cache()
    lap("ukbb192 paths")
    out["mimic192"] = cf_timed_update("mimic192", mimic, False, SEED + 156, profile=False)
    out["morphomnist"] = cf_timed_update("morphomnist", morph, False, SEED + 157, profile=False)
    lap("mimic192 and morphomnist paths")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cf_") as save_dir:
        out["cli"] = cf_cli_run(save_dir, morph)
    lap("cli.train_cf")
    log("cf_train", "seconds by part: " + ", ".join(f"{k} {v:.1f}"
                                                    for k, v in out["seconds"].items()))
    reset_counts()
    return out


# ---------------------------------------------------------------------------
# Slice 10: the flagship training setup (block remat at bs 128), the
# visualisations and the three stages end to end
# ---------------------------------------------------------------------------

REMAT_BS = 128  # the flagships' HVAE batch (checkpoints/*_flagship/vae/hparams.json)
# the flagships' remat (the same files): ukbb192 from 48^2 up, mimic192's
# GELU body everywhere; stage_scan picks JAX's unit, a decoder block of a run
REMAT_FLAGS = {"ukbb192": {"stage_scan": True, "remat": True, "remat_min_res": 48},
               "mimic192": {"stage_scan": True, "remat": True, "remat_min_res": 0}}
# where the ukbb192 flagship (checkpoints/ukbb192_flagship/vae/hparams.json)
# departs from the registry's ukbb192 in a field the step reads
UKBB_FLAGSHIP = {"z_max_res": 96, "beta": 5.0, "posterior_init_scale": 0.0}
FREE_GB = 8.0  # remat off at bs 128 runs only where it would leave this much free
REMAT_TIMED = 10  # steps a bs-128 ukbb192 median is taken over


def remat_config(name, dtype="bfloat16", bs=REMAT_BS, remat=True, flagship=False):
    """The flagship's HVAE configuration with its remat flags: ukbb192 (the
    registry's, or with ``flagship`` the flagship's z_max_res 96, beta and
    posterior init) or mimic192 (``mimic_config``), at ``bs``."""
    cfg = (ukbb_config if name == "ukbb192" else mimic_config)(dtype, bs)
    if flagship:
        cfg = cfg.replace(**UKBB_FLAGSHIP)
    return cfg.replace(**REMAT_FLAGS[name]).replace(remat=remat)


def remat_expected(cfg):
    """The launches of one train step: K1 on every stochastic block forward
    and once more for each stochastic block of a rematerialised cell (the
    recompute replays its draw), K1-bwd once on each; nothing else."""
    from causal_gen_tpu_torch.models.hvae import plan_decoder_blocks, remat_cells

    stages = plan_decoder_blocks(cfg)
    cells = sum(stages[i][0] <= cfg.z_max_res for i in remat_cells(cfg))
    want = expected_counts(cfg, 1)
    want["fused_sample_kl"] += cells
    return want


def _grads_of(model):
    import torch

    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
            for k, p in model.named_parameters()}


def remat_grads(cfg, bs, source, seed, device="cuda"):
    """One ELBO's gradients (train=True) with remat off and on, from one
    seeded model, batch and draws: injected normals (``source`` "injected")
    or a CPU generator of one seed; cuDNN deterministic. Returns the largest
    error relative to each tensor's largest value and each pass's
    launches."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.train.vae_trainer import preprocess_x, to_device

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    c = cfg.replace(bs=bs)
    batch = to_device(synth_batch(c, rng), dev)
    draws = [rng.standard_normal((bs, c.z_dim, r, r)).astype(np.float32) for r in k1_res(c)]
    state = HVAE(c.replace(remat=False), device="cpu",
                 generator=torch.Generator().manual_seed(SEED)).state_dict()
    grads, counts = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for on in (False, True):
            m = HVAE(c.replace(remat=on), device=dev)
            m.load_state_dict(state)
            kw = ({"noise": iter([torch.from_numpy(d).to(dev) for d in draws])}
                  if source == "injected" else {"generator": torch.Generator().manual_seed(seed)})
            reset_counts()
            out = m(preprocess_x(batch["x"]), batch["pa"], beta=c.beta, train=True, **kw)
            out["elbo"].backward()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            counts[on], grads[on] = read_counts(), _grads_of(m)
            del m
    finally:
        torch.backends.cudnn.deterministic = deterministic
    err = max(((grads[True][k] - grads[False][k]).abs().max()
               / grads[False][k].abs().max().clamp_min(1e-30)).item() for k in grads[False])
    return {"max_rel_err": err, "launches_off": counts[False], "launches_on": counts[True]}


def remat_step_card_vs_cpu(cfg, seed):
    """The first train step's ELBO terms and grad norm, card against the CPU
    plain path, from one seeded model, batch and injected draws."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import to_device, train_step

    rng = np.random.default_rng(seed)
    cpu_m = HVAE(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    gpu_m = HVAE(cfg, device="cuda")
    gpu_m.load_state_dict(cpu_m.state_dict())
    batch = synth_batch(cfg, rng)
    noise = [rng.standard_normal((cfg.bs, cfg.z_dim, r, r)).astype(np.float32)
             for r in k1_res(cfg)]
    ms = {}
    for d, m in (("cpu", cpu_m), ("cuda", gpu_m)):
        dv = torch.device(d)
        out = train_step(cfg, init_train_state(cfg, m), to_device(batch, dv),
                         noise=[[torch.from_numpy(e).to(dv) for e in noise]])
        ms[d] = {k: float(v) for k, v in out.items()}
    return {k: abs(ms["cuda"][k] - ms["cpu"][k]) / abs(ms["cpu"][k])
            for k in ("elbo", "nll", "kl", "grad_norm")}


def remat_step_time(cfg, n_timed, seed, profile=False):
    """``n_timed`` bf16 train steps of ``cfg`` after two, from seeded
    weights: the median ms, images/s and the peak memory of the run; the
    launches of the first step against ``remat_expected``; with
    ``profile``, one more step under the profiler (busy share, kernels)."""
    import gc

    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import to_device, train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = init_train_state(cfg, HVAE(cfg, device="cuda",
                                    generator=torch.Generator().manual_seed(SEED)))
    b = to_device(synth_batch(cfg, np.random.default_rng(seed)), torch.device("cuda"))
    gen = torch.Generator().manual_seed(seed)
    reset_counts()
    m = train_step(cfg, st, b, generator=gen)
    torch.cuda.synchronize()
    counts, want = read_counts(), remat_expected(cfg)
    if counts != want or not math.isfinite(float(m["elbo"])):
        raise AssertionError(f"{cfg.name} bs {cfg.bs} remat {cfg.remat}: launches {counts}, "
                             f"expected {want}; {m}")
    train_step(cfg, st, b, generator=gen)
    times = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(cfg, st, b, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    out = {"bs": cfg.bs, "remat": cfg.remat, "remat_min_res": cfg.remat_min_res,
           "step_ms": med, "step_ms_all": times, "images_per_s": cfg.bs / med * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
           "skipped": float(m["skipped"])}
    if profile:
        out["profile"] = profile_calls(lambda: train_step(cfg, st, b, generator=gen), 1, "step")
    del st, b
    gc.collect()
    torch.cuda.empty_cache()
    log("remat", f"{cfg.name} {cfg.dtype} bs {cfg.bs} remat {cfg.remat} (min res "
                 f"{cfg.remat_min_res}): median {med:.3f} ms over {n_timed} (min {min(times):.3f},"
                 f" max {max(times):.3f}) = {out['images_per_s']:.1f} images/s; peak memory "
                 f"{out['peak_mem_gb']:.2f} GB; launches {counts}")
    return out


def phase_remat():
    """The flagships' training setup: block remat on the ukbb192 and
    mimic192 HVAE train steps at bs 128 (bf16), ukbb192 at bs 32 with remat
    on and off, remat off at bs 128 where it fits; float32 gradients with
    remat on and off and card against CPU; no K2 in any step."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    c32 = remat_config("ukbb192", "float32", CHECK_BS)
    out = {"grads": {}}
    for src in ("injected", "generator"):
        g = remat_grads(c32, CHECK_BS, src, SEED + 200)
        off, on = g["launches_off"], g["launches_on"]
        if g["max_rel_err"] > 1e-6 or on != remat_expected(c32) or off != expected_counts(c32, 1):
            raise AssertionError(f"ukbb192 float32 remat on vs off ({src}): {g}")
        out["grads"][src] = g
        log("remat", f"ukbb192 float32 bs {CHECK_BS}, {src} draws: gradients remat on == off "
                     f"within {g['max_rel_err']:.2e} rel; K1 {off['fused_sample_kl']} -> "
                     f"{on['fused_sample_kl']}, K1-bwd {on['fused_sample_kl_bwd']}, K2 0")
    rel = remat_step_card_vs_cpu(c32, SEED + 201)
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"ukbb192 float32 remat step card vs CPU: {rel}")
    out["card_vs_cpu_rel_err"] = rel
    log("remat", "ukbb192 float32 remat step card == CPU plain path (TF32 off): "
                 + ", ".join(f"{k} rel {v:.2e}" for k, v in rel.items()))

    t = out["times"] = {}
    t["ukbb192_bs32_remat"] = remat_step_time(remat_config("ukbb192", bs=32), 3, SEED + 202)
    t["ukbb192_bs32_plain"] = remat_step_time(remat_config("ukbb192", bs=32, remat=False), 3,
                                              SEED + 202)
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    need_gb = 4 * t["ukbb192_bs32_plain"]["peak_mem_gb"]
    t["ukbb192_bs128_remat"] = remat_step_time(remat_config("ukbb192"), REMAT_TIMED, SEED + 203,
                                               profile=True)
    if total_gb - need_gb >= FREE_GB:
        t["ukbb192_bs128_plain"] = remat_step_time(remat_config("ukbb192", remat=False), 5,
                                                   SEED + 203)
    else:
        t["ukbb192_bs128_plain"] = {"not_run": True, "would_need_gb": need_gb,
                                    "card_gb": total_gb}
        log("remat", f"ukbb192 bf16 bs 128 remat off: not run, would need {need_gb:.1f} GB "
                     f"(4 x the bs-32 peak) of {total_gb:.1f}")
    # the ukbb192 flagship's own HVAE (z_max_res 96: no stochastic 192^2 block)
    t["ukbb192_flagship_bs128_remat"] = remat_step_time(
        remat_config("ukbb192", flagship=True), 5, SEED + 205)
    t["ukbb192_flagship_bs128_plain"] = remat_step_time(
        remat_config("ukbb192", remat=False, flagship=True), 5, SEED + 205)
    t["mimic192_bs128_remat"] = remat_step_time(remat_config("mimic192"), 5, SEED + 204)
    out["launches"] = {k: v["launches"] for k, v in t.items() if "launches" in v}
    return out


VIZ_CONFIGS = ("ukbb192", "morphomnist_cond_prior", "cmnist_dmol")
# the float32 card-vs-CPU grids: at the viz batch where the CPU draws it in
# seconds, at CHECK_BS on ukbb192 (80-row 192^2 passes on the CPU)
VIZ_CHECK_BS = {"ukbb192": CHECK_BS, "morphomnist_cond_prior": BS, "cmnist_dmol": BS}


def viz_config(name, dtype=None, bs=BS):
    """The viz cells: ukbb192 (the registry's, bf16), morphomnist with
    cond_prior (``variant_config``) and cmnist with the DMoL head."""
    from causal_gen_tpu_torch.config import get_config

    if name == "ukbb192":
        return ukbb_config(dtype or "bfloat16", bs)
    if name == "morphomnist_cond_prior":
        return variant_config("cond_prior", bs)
    return get_config("cmnist", bs=bs, x_like="diag_dmol")


def viz_noise(cfg, bs, rng, n_latents_viz=0):
    """The standard normals ``utils/viz.py::write_images`` takes, in its
    order: the abduction's, per cut level the reconstruction's for the
    blocks past the cut, ten samples', per cut level the tiled
    reconstruction's and direct effect's, and under cond_prior the mixture
    abduction's posterior and prior passes."""
    import numpy as np

    from causal_gen_tpu_torch.utils.viz import TEMPS

    res = k1_res(cfg)
    d = cfg.context_dim

    def normals(n, rs):
        return [rng.standard_normal((n, cfg.z_dim, r, r)).astype(np.float32) for r in rs]

    cuts = np.floor(np.linspace(0, 1, n_latents_viz + 2) * len(res)).astype(int)[1:]
    out = normals(bs, res)
    for cut in cuts:
        out += normals(bs, res[cut:])
    for _ in TEMPS:
        out += normals(bs, res)
    for cut in cuts:
        out += normals(bs * d, res[cut:]) + normals(bs * d, res[cut:])
        if cfg.cond_prior:
            out += normals(bs * d, res) + normals(bs * d, res)
    return out


def viz_rows_err(got, ref, cfg, bs, h, n_latents_viz=0):
    """(largest error of an image row, of a difference row modulo 256)
    between two grids."""
    import numpy as np

    from causal_gen_tpu_torch.utils.viz import TEMPS

    n_cut, n_eff = n_latents_viz + 1, 2 if cfg.cond_prior else 0
    first, per = 1 + n_cut + 1 + len(TEMPS) + 1, 2 * (1 + n_eff)
    diff_rows = [first + c * (bs * per + 1) + i * per + 2 * e + 1
                 for c in range(n_cut) for i in range(bs) for e in range(1 + n_eff)]
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16)).reshape(-1, h, got.shape[1],
                                                                      got.shape[2])
    image_rows = np.setdiff1d(np.arange(diff.shape[0]), diff_rows)
    wrapped = np.minimum(diff[diff_rows] % 256, 256 - diff[diff_rows] % 256)
    return int(diff[image_rows].max()), int(wrapped.max())


def viz_expected(cfg, vae):
    """write_images' launches (n_latents_viz 0): K1 in the abduction (and
    the mixture abduction's posterior pass), K2 on the covered blocks of
    each encoder and decoder pass outside autograd; K4 none (the sample rows
    decode the head's loc, as JAX's write_images asks)."""
    from causal_gen_tpu_torch.utils.viz import TEMPS

    enc, dec = k2_cover(vae)
    cp = int(cfg.cond_prior)
    k2 = enc * (1 + cp) + dec * (1 + 1 + len(TEMPS) + 2 + 4 * cp)
    k2_dtype = "fused_light_block_tc" if cfg.dtype == "bfloat16" else "fused_light_block_simt"
    want = dict(expected_counts(cfg, 0), fused_sample_kl=len(k1_res(cfg)) * (1 + cp),
                fused_light_block=k2)
    want[k2_dtype] = k2
    return want


def phase_viz():
    """utils/viz.py::write_images on ukbb192 (bf16: K2 and K1), morphomnist
    with cond_prior (the indirect and total rows) and cmnist with the DMoL
    head: the card's float32 grid against the CPU plain path's on the same
    weights, batch and draws (uint8 within 1; ukbb192 at bs CHECK_BS, the
    others at their viz batch, BS), then each at the viz batch cli.main draws
    (min(context_dim * 5, bs)) with its launches and time."""
    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.utils.viz import write_images

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name in VIZ_CONFIGS:
        rng = np.random.default_rng(SEED + 210)
        n = VIZ_CHECK_BS[name]
        c = viz_config(name, "float32" if name == "ukbb192" else None, n)
        cpu_m = HVAE(c, device="cpu", generator=torch.Generator().manual_seed(SEED))
        if name == "morphomnist_cond_prior":  # the zero prior heads would hide the parents
            fill_zero_leaves(cpu_m, torch.Generator().manual_seed(SEED + 120))
        gpu_m = HVAE(c, device="cuda")
        gpu_m.load_state_dict(cpu_m.state_dict())
        batch = synth_batch(c, rng)
        draws = viz_noise(c, n, rng)
        grids = {}
        for d, m in (("cpu", cpu_m), ("cuda", gpu_m)):
            taken = iter([torch.from_numpy(e).to(torch.device(d)) for e in draws])
            grids[d] = write_images(c, m.eval(), batch, None, noise=taken)
            if next(taken, None) is not None:
                raise AssertionError(f"viz {name}: write_images left draws unused")
        img_err, diff_err = viz_rows_err(grids["cuda"], grids["cpu"], c, n, c.input_res)
        if grids["cuda"].shape != grids["cpu"].shape or img_err > 1 or diff_err > 1:
            raise AssertionError(f"viz {name}: card grid vs CPU: {img_err}, {diff_err}")
        del cpu_m, gpu_m

        cfg = viz_config(name)
        vb = synth_batch(cfg.replace(bs=min(cfg.context_dim * 5, cfg.bs)), rng)
        vae = HVAE(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
        reset_counts()
        grid = write_images(cfg, vae.eval(), vb, None)
        torch.cuda.synchronize()
        counts, want = read_counts(), viz_expected(cfg, vae)
        if counts != want or grid.dtype != np.uint8:
            raise AssertionError(f"viz {name}: launches {counts}, expected {want}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            write_images(cfg, vae, vb, None)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        del vae
        out[name] = {"check_bs": n, "max_err_image_rows": img_err, "max_err_diff_rows": diff_err,
                     "viz_bs": vb["x"].shape[0], "grid_shape": list(grid.shape),
                     "launches": counts, "ms": statistics.median(times), "ms_all": times}
        log("viz", f"{name} ({cfg.dtype}): float32 grid bs {n} card vs CPU within {img_err} "
                   f"(image rows) / {diff_err} (difference rows); viz batch {vb['x'].shape[0]}:"
                   f" grid {grid.shape}, median {out[name]['ms']:.1f} ms over 3, launches "
                   f"{counts}")
    return out


# the data reach the CLIs in memory (--in_memory), the path taken where PIL
# is missing; the tree's PNG round trip is held on the CPU
E2E_ARGS = ["--dataset", "ukbb", "--flagship", "--n", "16", "--bs", "8", "--epochs", "1",
            "--cf_max_batches", "2", "--eval_seeds", "0", "--device", "cuda", "--in_memory"]


def phase_e2e():
    """tools/e2e_synth_torch.py on the card at the ukbb192 flagship config
    (192^2, bf16, stage_scan and remat from 48^2) with reduced data: 16 per
    split, bs 8, 1 epoch, 2 CF updates, one eval seed; each stage run on its
    own, reading the last one's checkpoint, with its seconds and launches."""
    import importlib.util
    import tempfile

    import torch

    spec = importlib.util.spec_from_file_location(
        "e2e_synth_torch", os.path.join(ROOT, "tools", "e2e_synth_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    out = {"stages": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_e2e_") as tmp:
        dirs = ["--root", os.path.join(tmp, "tree"), "--out", os.path.join(tmp, "out")]
        for stage in "1234":
            reset_counts()
            r = twin.main(E2E_ARGS + dirs + ["--stages", stage])
            torch.cuda.synchronize()
            out["stages"][stage] = {"seconds": r["seconds"][stage], "launches": read_counts(),
                                    "updates_made_skipped": r["updates"].get(stage)}
            log("e2e", f"stage {stage}: {r['seconds'][stage]:.1f} s, launches "
                       f"{out['stages'][stage]['launches']}"
                       + (f", updates made / skipped {r['updates'][stage]}"
                          if stage in r["updates"] else ""))
        for role in ("vae", "pgm", "aux", "cf"):
            if not os.path.exists(os.path.join(tmp, "out", role, "checkpoint")):
                raise AssertionError(f"e2e: no {role} checkpoint")
        metrics = r["eval"]["metrics"]
        if not metrics or not all(math.isfinite(m["mean"]) for m in metrics.values()):
            raise AssertionError(f"e2e: stage 4 metrics {metrics}")
    out["eval_metrics"] = metrics
    return out


# ---- 27. parallel: the mesh path of parallel/ on the card ----------------------
PAR_BS = 32  # the data-parallel check's global batch: 16 a rank
PAR_F32_BS = 4  # the float32 checks' global batch (data, tensor and spatial)
PAR_LABEL = "2 ranks on one H100 over gloo"


def par_inputs(cfg, seed, device):
    """A global batch of cfg.bs (uint8 NC(D)HW x, parents uniform in [-1, 1])
    and the whole-map normals of every stochastic block, drawn on ``device``
    from a seeded generator, so every rank draws the same."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.bs, cfg.input_channels) + (cfg.input_res,) * cfg.spatial_dims
    x = torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)
    pa = torch.rand((cfg.bs, cfg.context_dim), generator=g, device=device) * 2 - 1
    noise = [torch.randn((cfg.bs, cfg.z_dim) + (r,) * cfg.spatial_dims, generator=g,
                         device=device) for r in k1_res(cfg)]
    return {"x": x, "pa": pa}, noise


def par_sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def par_rows(mesh, noise):
    """This rank's rows of each whole-map draw (its ``data`` share)."""
    import torch

    from causal_gen_tpu_torch.parallel import batch_sharding

    return [e[torch.from_numpy(batch_sharding(mesh, len(e))).to(e.device)] for e in noise]


def par_step(cfg, batch, noise, device, mesh=None, tp_min=0, spatial=False, n_timed=0):
    """One train step of a seeded HVAE on ``batch`` with the injected draws
    (under ``mesh`` on this rank's part): its metrics, the launches around
    it, its peak memory, and the median host-clock ms of ``n_timed`` more
    steps; and the state after the first step (when ``n_timed`` is 0)."""
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.parallel import shard_batch, shard_batch_spatial, shard_params_tp
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import train_step

    model = HVAE(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
    if mesh is not None:
        shard_params_tp(model, mesh, tp_min or 10**9)
        batch = (shard_batch_spatial if spatial else shard_batch)(mesh, batch)
        noise = par_rows(mesh, noise)
    state = init_train_state(cfg, model)
    cuda = device.type == "cuda"
    par_sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    m = train_step(cfg, state, batch, noise=[noise], mesh=mesh)
    par_sync(device)
    out = {"metrics": {k: float(v) for k, v in m.items()}, "launches": read_counts(),
           "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None}
    if n_timed:
        times = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            train_step(cfg, state, batch, noise=[noise], mesh=mesh)
            par_sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out["step_ms"], out["step_ms_all"] = statistics.median(times), times
        state = None
    return out, state


def par_rel(got, ref, keys=("elbo", "nll", "kl", "grad_norm")):
    return {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in keys}


def par_forward(cfg, batch, noise, device, mesh=None):
    """A seeded HVAE's forward outside autograd (where its light blocks take
    K2), under ``mesh`` spatially sharded: ELBO terms (the global batch's)
    and the launches around it."""
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.parallel import shard_batch_spatial
    from causal_gen_tpu_torch.train.vae_trainer import preprocess_x

    model = HVAE(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
    if mesh is not None:
        batch = shard_batch_spatial(mesh, batch)
        noise = par_rows(mesh, noise)
    reset_counts()
    with torch.inference_mode():
        out = model(preprocess_x(batch["x"]), batch["pa"], noise=iter(noise), train=False,
                    mesh=mesh)
        if mesh is not None:
            out = mesh.reduce_metrics({k: out[k] for k in ("elbo", "nll", "kl")})
    par_sync(device)
    return {"metrics": {k: float(out[k]) for k in ("elbo", "nll", "kl")},
            "launches": read_counts()}


def parallel_rank(rank, world, device, cfg_bf16, cfg_f32, cfg_fwd):
    """The parallel phase's checks on one rank of ``world`` (the launcher of
    ``parallel/launch.py``); rank 0 also runs each check's one-process step
    and raises where they disagree."""
    import torch
    import torch.distributed as dist

    from causal_gen_tpu_torch.parallel import make_mesh
    from causal_gen_tpu_torch.parallel.tensor import gather_state, sharded_layers

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    out = {"backend": dist.get_backend(), "device": str(device)}
    # PyTorch's backend table: gloo's all_gather takes no CUDA tensor
    probe = torch.ones(2, device=device)
    try:
        dist.all_gather([torch.empty_like(probe) for _ in range(world)], probe)
        out["gloo_all_gather_cuda"] = "moved"
    except RuntimeError as e:
        out["gloo_all_gather_cuda"] = "refused: " + str(e).strip().splitlines()[0][:160]

    dp_mesh = make_mesh((world,), ("data",))
    batch, noise = par_inputs(cfg_bf16, SEED + 200, device)
    out["dp_bf16"], _ = par_step(cfg_bf16, batch, noise, device, dp_mesh, n_timed=3)
    if rank == 0:  # one process at the global batch, timed the same way
        ref, _ = par_step(cfg_bf16, batch, noise, device, n_timed=3)
        rel = par_rel(out["dp_bf16"]["metrics"], ref["metrics"], ("elbo", "nll", "kl"))
        out["dp_bf16"].update(ref_metrics=ref["metrics"], ref_launches=ref["launches"], rel=rel,
                              ref_step_ms=ref["step_ms"], ref_peak_gb=ref["peak_gb"])
        if max(rel.values()) > 2e-2:
            raise AssertionError(f"data parallel bf16 step vs one process: {rel}")
    del batch, noise

    b32, n32 = par_inputs(cfg_f32, SEED + 201, device)
    ref = ref_params = None
    if rank == 0:
        ref, st = par_step(cfg_f32, b32, n32, device)
        ref_params = gather_state(st.model)
        del st
    checks = {"dp_f32": dict(mesh=dp_mesh),
              "tp_f32": dict(mesh=make_mesh((1, world), ("data", "model")), tp_min=256),
              "sp_f32": dict(mesh=make_mesh((1, world), ("data", "space")), spatial=True)}
    for name, kw in checks.items():
        res, st = par_step(cfg_f32, b32, n32, device, **kw)
        res["n_sharded_layers"] = len(sharded_layers(st.model))
        got = gather_state(st.model)
        del st
        if rank == 0:
            errs = torch.cat([(got[k] - ref_params[k]).abs().flatten() for k in got])
            res["param_err"] = float(errs.max())
            res["params_over_1e-5"] = [int((errs > 1e-5).sum()), errs.numel()]
            res["rel"] = par_rel(res["metrics"], ref["metrics"])
            tol = 1e-3 if name == "sp_f32" else 1e-4  # SP: the NLL's reassociation (JAX's 1e-3)
            # 2 lr cannot fail after Adam's first update (lr g / (|g| + eps)): the
            # share beyond 1e-5 catches a wrong gradient, which moves most elements
            if (res["param_err"] > 2 * cfg_f32.lr or max(res["rel"].values()) > tol
                    or res["params_over_1e-5"][0] > 1e-3 * errs.numel()):
                raise AssertionError(f"{name} vs one process: rel {res['rel']}, parameters "
                                     f"{res['param_err']:.3e} (2 lr = {2 * cfg_f32.lr:.1e}), "
                                     f"{res['params_over_1e-5']} beyond 1e-5 (at most 1e-3)")
        out[name] = res
    if rank == 0:
        out["f32_ref_metrics"] = ref["metrics"]
    del b32, n32, ref_params

    bf, nf = par_inputs(cfg_fwd, SEED + 202, device)
    out["sp_forward_bf16"] = par_forward(cfg_fwd, bf, nf, device,
                                         checks["sp_f32"]["mesh"])
    if rank == 0:
        ref = par_forward(cfg_fwd, bf, nf, device)
        rel = par_rel(out["sp_forward_bf16"]["metrics"], ref["metrics"], ("elbo", "nll", "kl"))
        out["sp_forward_bf16"].update(ref_launches=ref["launches"], rel=rel)
        k2 = "fused_light_block"
        if (max(rel.values()) > 2e-2 or out["sp_forward_bf16"]["launches"][k2] == 0
                or out["sp_forward_bf16"]["launches"][k2] != ref["launches"][k2]):
            raise AssertionError(f"spatially sharded bf16 forward: rel {rel}, launches "
                                 f"{out['sp_forward_bf16']['launches']} vs {ref['launches']}")
    out["seconds"] = time.perf_counter() - t_start
    return out


def nccl_rank(rank, world, device, cfg):
    """NCCL at world 1: one Morpho-MNIST train step through the mesh path
    against the same step without a mesh."""
    from causal_gen_tpu_torch.parallel import make_mesh
    import torch.distributed as dist

    batch, noise = par_inputs(cfg, SEED + 203, device)
    got, _ = par_step(cfg, batch, noise, device, make_mesh((1,), ("data",)))
    ref, _ = par_step(cfg, batch, noise, device)
    rel = par_rel(got["metrics"], ref["metrics"])
    if max(rel.values()) > 1e-4 or got["launches"] != ref["launches"]:
        raise AssertionError(f"NCCL world-1 step vs no mesh: {rel}, {got['launches']}")
    return {"backend": dist.get_backend(), "rel": rel, **got}


def k2_slab_check(cfg, bs, device):
    """K2 against its plain version at the spatially sharded forward's slab
    shapes: each covered ukbb192 block at a sharded resolution, on a border
    rank's slab (res / 2 + 2 rows, res wide) at ``bs``, bf16 and float32."""
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.ops.fused_block import fused_light_block, fused_light_block_ref

    vae = HVAE(cfg, device="cpu")
    shapes = sorted(k2_blocks_by_shape(cfg, vae))
    errs = {}
    for c, cb, res in shapes:
        if res % 4:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            args = k2_inputs(bs, c, cb, res // 2 + 2, res, dtype, True, device)
            got = fused_light_block(*args)
            ref = fused_light_block_ref(*args)
            errs[f"{(bs, c, cb, res // 2 + 2, res)} {str(dtype)[6:]}"] = k2_compare(args, got,
                                                                                  ref)[0]
    return errs


def phase_parallel():
    """Phase 27 (module docstring)."""
    import torch

    from causal_gen_tpu_torch.config import get_config
    from causal_gen_tpu_torch.ops.build import build_all
    from causal_gen_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    build_all()  # the ranks find the kernels built
    torch.backends.cudnn.allow_tf32 = False  # the float32 plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    k2_errs = k2_slab_check(ukbb_config(), PAR_F32_BS, dev)
    log("parallel", f"K2 vs its plain version at {len(k2_errs)} slab shapes of the spatially "
                    f"sharded ukbb192 forward (bf16 and float32): max err "
                    f"{max(k2_errs.values()):.3e}")
    nccl = spawn(nccl_rank, 1, (get_config("morphomnist", bs=BS),), device="cuda",
                 backend="nccl", timeout=300)[0]
    log("parallel", f"NCCL at world 1 ({nccl['backend']}): a morphomnist train step bs {BS} "
                    f"through the mesh path == without it (rel {max(nccl['rel'].values()):.1e}), "
                    f"launches {nccl['launches']}")
    ranks = spawn(parallel_rank, 2,
                  (ukbb_config("bfloat16", PAR_BS),
                   ukbb_config("float32", PAR_F32_BS).replace(lr_warmup_steps=0),
                   ukbb_config("bfloat16", PAR_F32_BS)), device="cuda", backend="gloo",
                  timeout=600)
    r0 = ranks[0]
    log("parallel", f"gloo all_gather on a CUDA tensor: {r0['gloo_all_gather_cuda']}; "
                    f"the collective layer stages gloo's all-gather and halo exchanges of "
                    f"CUDA tensors through host memory all the same (all-reduce and "
                    f"broadcast go to gloo as they are)")
    dp = r0["dp_bf16"]
    log("parallel", f"ukbb192 bf16 DP step, global bs {PAR_BS} (16 a rank), {PAR_LABEL}: "
                    f"ELBO terms vs one process rel "
                    + ", ".join(f"{k} {v:.2e}" for k, v in dp["rel"].items())
                    + "; K1 / K1-bwd launches a rank "
                    + ", ".join(f"{r['dp_bf16']['launches']['fused_sample_kl']} + "
                                f"{r['dp_bf16']['launches']['fused_sample_kl_bwd']}"
                                for r in ranks)
                    + f" (one process: {dp['ref_launches']['fused_sample_kl']} + "
                      f"{dp['ref_launches']['fused_sample_kl_bwd']})")
    for name in ("dp_f32", "tp_f32", "sp_f32"):
        c = r0[name]
        log("parallel", f"{name} ukbb192 float32 global bs {PAR_F32_BS}: parameters after the "
                        f"update within {c['param_err']:.2e} of one process (2 lr "
                        f"{2e-3:.0e}; {c['params_over_1e-5'][0]} of "
                        f"{c['params_over_1e-5'][1]} beyond 1e-5, at most a thousandth), "
                        f"metrics rel "
                        f"{max(c['rel'].values()):.2e}, {c['n_sharded_layers']} column-parallel "
                        f"layers")
    f = r0["sp_forward_bf16"]
    log("parallel", f"spatially sharded ukbb192 bf16 forward bs {PAR_F32_BS}: K2 launches a "
                    f"rank {[r['sp_forward_bf16']['launches']['fused_light_block'] for r in ranks]}"
                    f" (one process {f['ref_launches']['fused_light_block']}), ELBO terms rel "
                    f"{max(f['rel'].values()):.2e}")
    seconds = time.perf_counter() - t0
    log("parallel", f"{PAR_LABEL} (not a multi-GPU scaling figure): DP bf16 step "
                    + ", ".join(f"rank {i} {r['dp_bf16']['step_ms']:.1f} ms "
                                f"(peak {r['dp_bf16']['peak_gb']:.2f} GB)"
                                for i, r in enumerate(ranks))
                    + f"; one process at bs {PAR_BS} in the same call {dp['ref_step_ms']:.1f} ms "
                      f"(peak {dp['ref_peak_gb']:.2f} GB); phase {seconds:.1f} s")
    launches = {f"train_step ukbb192 bf16 DP rank {i} of 2 ({PAR_LABEL})": r["dp_bf16"]["launches"]
                for i, r in enumerate(ranks)}
    launches.update({f"HVAE.forward ukbb192 bf16 SP rank {i} of 2 ({PAR_LABEL})":
                     r["sp_forward_bf16"]["launches"] for i, r in enumerate(ranks)})
    launches["train_step morphomnist DP world 1 (NCCL)"] = nccl["launches"]
    return {"label": PAR_LABEL, "k2_slab_errs": k2_errs,
            "k2_slab_max_abs_err": {d: max(v for k, v in k2_errs.items() if k.endswith(d))
                                    for d in ("bfloat16", "float32")}, "nccl": nccl, "ranks": ranks, "launches": launches,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# Slice 12: the tail (the native augment pass, space-to-depth convs, the
# profiling hooks and tools)
# ---------------------------------------------------------------------------

TAIL_UKBB_BS = 128  # the ukbb192 flagship's HVAE batch (checkpoints/ukbb192_flagship/vae)
TAIL_POOL = 512  # images the tail's batches are drawn from (a 192^2 uint8 pool, 18.9 MB)
TAIL_S2D = (32, 32, 8, 192)  # (bs, C, b, res): a narrow ukbb192 light block's first conv
TAIL_STEP_SCOPE = "tail_train_step"


def tail_native():
    """The native augment pass built on this machine, held byte for byte
    against its plain version (data/augment.py) at the ukbb192 flagship's
    train batch (the UKBB loader's aug: padding (pad, 2 pad), hflip) and at a
    ragged batch with hflip 0, both timed in ms a batch."""
    import numpy as np

    from causal_gen_tpu_torch.config import get_config
    from causal_gen_tpu_torch.data import augment, native
    from causal_gen_tpu_torch.data.datasets import ArrayDataset

    built = native.library_path().is_file()  # by an earlier phase's loader
    t0 = time.perf_counter()
    lib = native.build()
    build_s = None if built else time.perf_counter() - t0
    cxx = subprocess.run([native.compiler(), "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.splitlines()[0]
    cfg = get_config("ukbb192")
    res = cfg.input_res
    rng = np.random.default_rng(SEED + 90)
    pool = rng.integers(0, 256, (TAIL_POOL, res, res, 1)).astype(np.uint8)
    # the UKBB loader's train split (data/datasets.py::ukbb_from_rows)
    ds = ArrayDataset(images=pool, attrs={"pa": np.zeros((TAIL_POOL, 1), np.float32)},
                      columns=("pa",),
                      aug=("random_crop_flip", (res, res), (cfg.pad, 2 * cfg.pad), cfg.hflip))
    how = "built by an earlier phase's loader" if built else f"built in {build_s:.2f} s"
    log("tail", f"native pass {how} ({cxx}) into {lib}")
    out = {"build_s": build_s, "library": str(lib), "compiler": cxx, "cases": {}}
    cases = {f"ukbb192 flagship train batch bs {TAIL_UKBB_BS}":
             (TAIL_UKBB_BS, ds.aug[1], ds.aug[2], ds.aug[3]),
             "ragged bs 37, (181, 190), padding (5, 0), hflip 0": (37, (181, 190), (5, 0), 0.0)}
    for name, (n, size, padding, hflip) in cases.items():
        idx = rng.permutation(TAIL_POOL)[:n]

        def run_native(s, idx=idx, size=size, padding=padding, hflip=hflip):
            if (size, padding, hflip) == ds.aug[1:]:  # the loader's path
                return ds.batch(idx, np.random.default_rng(s))["x"]
            return native.gather_crop_flip(pool, idx, np.random.default_rng(s), size, padding,
                                           hflip)

        def run_plain(s, idx=idx, size=size, padding=padding, hflip=hflip):
            return augment.gather_crop_flip(pool, idx, np.random.default_rng(s), size, padding,
                                            hflip)
        for s in range(3):
            got, ref = run_native(s), run_plain(s)
            if got.shape != (n, *size, 1) or not np.array_equal(got, ref):
                raise AssertionError(f"tail: native pass != plain version ({name}, seed {s}): "
                                     f"{int((got != ref).sum())} bytes differ")
        times = {}
        for what, fn in (("native", run_native), ("plain", run_plain)):
            ts = []
            for s in range(10):
                t1 = time.perf_counter()
                fn(s)
                ts.append((time.perf_counter() - t1) * 1e3)
            times[what] = statistics.median(ts)
        out["cases"][name] = {"ms_native": times["native"], "ms_plain": times["plain"],
                              "identical": True}
        log("tail", f"native pass == plain version byte for byte, {name}: "
                    f"{times['native']:.3f} ms a batch against {times['plain']:.3f} ms "
                    f"(median of 10, host clock)")
    return out


def tail_s2d():
    """s2d_conv against F.conv2d on the card at a narrow ukbb192 192^2 conv
    (C 32 -> 8, 3x3, bs 32): float32 with TF32 off within 1e-4 of F.conv2d
    (the packed conv sums in another order); bf16 within 2 bf16 ulps of the
    largest output of the float32 conv of the same rounded inputs. Times
    (CUDA graphs) of the plain conv, the stage-packed conv (s2d_conv with
    packed_in and packed_out, its kernel packed in the call), the packed
    conv alone and s2d_conv with its pack and unpack."""
    import torch
    import torch.nn.functional as F

    from causal_gen_tpu_torch.ops import s2d

    bs, c, b, r = TAIL_S2D
    g = torch.Generator().manual_seed(SEED + 91)
    x = torch.randn(bs, c, r, r, generator=g).cuda()
    w = (torch.randn(b, c, 3, 3, generator=g) / math.sqrt(9 * c)).cuda()
    bias = (0.1 * torch.randn(b, generator=g)).cuda()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd, wd, bd = x.to(dtype), w.to(dtype), bias.to(dtype)
        ref32 = F.conv2d(xd.float(), wd.float(), bd.float(), padding=1)
        plain = F.conv2d(xd, wd, bd, padding=1)
        got = s2d.s2d_conv(xd, wd, bd)
        err = (got.float() - ref32).abs().max().item()
        err_plain = (plain.float() - ref32).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2 * bf16_ulp(ref32.abs().max()).item()
        if not err <= tol:
            raise AssertionError(f"tail: s2d_conv {dtype} max abs err {err:.3e} > {tol:.3e}")
        p = s2d.pack_space_to_depth(xd)
        wp = s2d.pack_kernel_3x3(wd)
        fns = {"plain_conv": lambda: F.conv2d(xd, wd, bd, padding=1),
               "s2d_stage_packed": lambda: s2d.s2d_conv(p, wd, bd, packed_in=True,
                                                        packed_out=True),
               "packed_conv_only": lambda: F.conv2d(p, wp, padding=1),
               "s2d_conv_with_pack_unpack": lambda: s2d.s2d_conv(xd, wd, bd)}
        us = {k: cuda_time_ms([fn], reps=20, per_graph=12) * 1e3 for k, fn in fns.items()}
        name = str(dtype)[6:]
        out[name] = {"max_abs_err": err, "plain_max_abs_err": err_plain, "tol": tol, "us": us}
        log("tail", f"s2d_conv {name} at (bs {bs}, C {c} -> {b}, {r}^2, 3x3): max abs err "
                    f"{err:.3e} against the float32 conv (F.conv2d {name}: {err_plain:.3e}; "
                    f"tol {tol:.1e}); us a call: "
                    + ", ".join(f"{k} {v:.1f}" for k, v in us.items()))
    return out


def tail_profile():
    """One Morpho-MNIST float32 train step at bs 32 (the main path, its
    launches counted) under utils/profiling.trace: trace_ops_torch's reader
    finds K1's and K1-bwd's kernels in the trace, 20 each, inside the step's
    annotate scope; device_time_torch's device ms a step; StepTimer over 5
    steps."""
    import tempfile

    import numpy as np
    import torch

    from causal_gen_tpu_torch.models.hvae import HVAE
    from causal_gen_tpu_torch.train.state import init_train_state
    from causal_gen_tpu_torch.train.vae_trainer import to_device, train_step
    from causal_gen_tpu_torch.utils import profiling
    from tools.device_time_torch import device_ms_per_iter
    from tools.trace_ops_torch import read_ops, summarize

    cfg = train_config("morphomnist")
    state = init_train_state(cfg, HVAE(cfg, device="cuda",
                                       generator=torch.Generator().manual_seed(SEED)))
    batch = to_device(synth_batch(cfg, np.random.default_rng(SEED + 92)), torch.device("cuda"))
    gen = torch.Generator().manual_seed(SEED + 93)
    train_step(cfg, state, batch, generator=gen)  # warm-up
    torch.cuda.synchronize()
    n_sto = len(k1_res(cfg))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tdir:
        reset_counts()
        t0 = time.perf_counter()
        with profiling.trace(tdir):
            with profiling.annotate(TAIL_STEP_SCOPE):
                train_step(cfg, state, batch, generator=gen)
        trace_s = time.perf_counter() - t0
        counts = read_counts()
        t0 = time.perf_counter()
        ops = read_ops(tdir)
        read_s = time.perf_counter() - t0
        trace_mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tdir)
                       for f in fs) / 1e6
    want = expected_counts(cfg, 1)
    if counts != want:
        raise AssertionError(f"tail: launches around the traced step {counts}, expected {want}")
    found = {k: [op for op in ops if op.device and pat in op.name]
             for k, pat in (("fused_sample_kl", "sample_kl_kernel"),
                            ("fused_sample_kl_bwd", "sample_kl_backward_kernel"))}
    in_scope = {k: sum(TAIL_STEP_SCOPE in op.scopes for op in v) for k, v in found.items()}
    if any(len(v) != n_sto for v in found.values()) or any(n != n_sto for n in in_scope.values()):
        raise AssertionError(f"tail: the trace holds K1 / K1-bwd "
                             f"{[len(v) for v in found.values()]} times, "
                             f"{list(in_scope.values())} in the step's scope; expected {n_sto}")
    s = summarize(ops)
    unscoped = sum(op.us for op in ops if TAIL_STEP_SCOPE not in op.scopes)
    step_ms = device_ms_per_iter(lambda i: train_step(cfg, state, batch, generator=gen),
                                 iters=3, windows=2, scope="tail_device_time", tag="tail")
    timer = profiling.StepTimer(skip_first=0)
    for _ in range(5):
        timer.start()
        timer.stop(train_step(cfg, state, batch, generator=gen))
    out = {"launches": counts, "trace_kernels": {k: len(v) for k, v in found.items()},
           "trace_kernels_in_scope": in_scope,
           "trace_k1_us": {k: sum(op.us for op in v) for k, v in found.items()},
           "trace_device_ms": s["total_us"] / 1e3, "trace_device_ms_outside_scope": unscoped / 1e3,
           "trace_events": len(ops), "trace_top": [(n[:80], us, c) for n, us, c in s["by_op"][:6]],
           "trace_s": trace_s, "read_s": read_s, "trace_mb": trace_mb,
           "device_ms_per_step": step_ms, "step_timer_ms": timer.mean_ms,
           "step_timer_images_per_s": timer.throughput(cfg.bs), "step_timer_times": timer.times}
    log("tail", f"morphomnist float32 step bs {cfg.bs} under profiling.trace ({trace_s:.2f} s, "
                f"{trace_mb:.1f} MB, read once in {read_s:.2f} s): K1 / K1-bwd kernels "
                f"{out['trace_kernels']['fused_sample_kl']} / "
                f"{out['trace_kernels']['fused_sample_kl_bwd']} in the trace, all in the step's "
                f"scope, {out['trace_k1_us']['fused_sample_kl']:.1f} / "
                f"{out['trace_k1_us']['fused_sample_kl_bwd']:.1f} us; {len(ops)} device events, "
                f"{out['trace_device_ms']:.3f} ms ({unscoped / 1e3:.3f} ms outside the scope); "
                f"launches counted {counts['fused_sample_kl']} + "
                f"{counts['fused_sample_kl_bwd']}")
    log("tail", f"device_time_torch: {step_ms:.3f} device ms a step (best of 2 windows of 3); "
                f"StepTimer over 5 steps: {timer.mean_ms:.3f} ms a step, "
                f"{out['step_timer_images_per_s']:.1f} images/s (host clock)")
    return out


def phase_tail(smi):
    """Phase 28 (module docstring)."""
    import torch

    from tools import mfu_torch

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False  # the float32 checks and MFU's float32 peak
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": smi, "native": tail_native(), "s2d": tail_s2d(), "profile": tail_profile()}
    mfu = mfu_torch.measure(train_config("morphomnist", bs=BENCH_BS), windows=3, iters=3,
                            seed=SEED)
    if mfu["peak"] != "float32" or not mfu["flops_per_step_g"] > 0:
        raise AssertionError(f"tail: mfu_torch peak {mfu['peak']}, FLOPs {mfu['flops_per_step_g']}")
    out["mfu"] = mfu
    log("tail", f"mfu_torch morphomnist bs {BENCH_BS} float32 (TF32 off): "
                f"{mfu['ms_per_step_best']:.3f} ms a step best, {mfu['ms_per_step_median']:.3f} "
                f"median (3 windows of 3), {mfu['flops_per_step_g']:.2f} GFLOP a step "
                f"(FlopCounterMode: convs and matmuls), MFU {mfu['mfu_best_pct']:.2f}% of "
                f"{mfu_torch.H100_PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s; {mfu['card']}")
    out["seconds"] = time.perf_counter() - t0
    return out


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
    ap.add_argument("--phases", help="run only these phases (comma-separated names, e.g. "
                                     "remat,viz,e2e; device and build always run) and print no "
                                     "result line")
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
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        seconds[name] = time.perf_counter() - t0
        log("time", f"phase {name}: {seconds[name]:.1f} s (run at {time.perf_counter() - t_start:.1f} s)")
        return r

    phases = [
        ("K1", lambda: phase_k1(cfg)), ("K1-bwd", lambda: phase_k1_bwd(cfg)),
        ("K3", phase_k3), ("K4", phase_k4), ("K2", phase_k2),
        ("slice", lambda: phase_slice(cfg)), ("sample", lambda: phase_sample(cfg)),
        ("train", lambda: {n: phase_train(n) for n in TRAIN_CONFIGS}),
        ("entry", lambda: {n: phase_entry(n) for n in TRAIN_CONFIGS}),
        ("ukbb", phase_ukbb_slice), ("ukbb-sample", phase_ukbb_sample),
        ("ukbb-train", phase_ukbb_train), ("ukbb64", phase_ukbb64), ("mimic", phase_mimic),
        ("cond_prior", phase_cond_prior), ("vol3d", phase_vol3d),
        ("pgm_train", lambda: {**phase_pgm_train(), **phase_pgm_train(("semi_sup_mimic",))}),
        ("dense_cf", lambda: phase_dense_cf(cfg)), ("cmnist_cf", phase_cmnist_cf),
        ("simple_vae", phase_simple_vae), ("cf_train", phase_cf_train),
        ("remat", phase_remat), ("viz", phase_viz), ("e2e", phase_e2e),
        ("parallel", phase_parallel), ("tail", lambda: phase_tail(smi))]
    chosen = None if args.phases is None else set(args.phases.split(","))
    if chosen is not None and not chosen <= {n for n, _ in phases}:
        raise SystemExit(f"--phases: unknown {sorted(chosen - {n for n, _ in phases})}")
    build_s = timed("build", phase_build)
    res = {n: timed(n, fn) for n, fn in phases if chosen is None or n in chosen}
    if chosen is not None:
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
            with open(args.json, "w") as f:
                json.dump({"device": name, "nvidia_smi": smi, "build_s": build_s, **res,
                           "phase_seconds": seconds,
                           "total_s": time.perf_counter() - t_start}, f, indent=1, default=str)
        log("done", f"phases {sorted(chosen)} passed in {time.perf_counter() - t_start:.1f} s "
                    f"on {smi}")
        timer.cancel()
        return 0
    k1, k1b, k3, k4, k2 = res["K1"], res["K1-bwd"], res["K3"], res["K4"], res["K2"]
    sl, samp, train, entry = res["slice"], res["sample"], res["train"], res["entry"]
    uk, uk_samp, uk_train, uk64 = res["ukbb"], res["ukbb-sample"], res["ukbb-train"], res["ukbb64"]
    mim, cp, vol, pgm = res["mimic"], res["cond_prior"], res["vol3d"], res["pgm_train"]
    dcf, ccf, svae, cft = res["dense_cf"], res["cmnist_cf"], res["simple_vae"], res["cf_train"]
    rem, vz, e2e, par = res["remat"], res["viz"], res["e2e"], res["parallel"]
    tl = res["tail"]
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
    by_path.update({"DSCM.forward(do_mask) morphomnist": dcf["launches"],
                    "DSCM.forward(do_mask) ukbb192 bf16 bs 2": dcf["ukbb192"]["launches"],
                    "DSCM.forward cmnist": ccf["launches"]})
    by_path.update({f"train_pgm {n}": r["launches"] for n, r in pgm.items()})
    by_path.update({f"DSCM.forward + sample simple_vae {v}": svae[v]["launches"] for v in svae})
    by_path.update({"cf_train_step ukbb192 bf16": cft["ukbb192"]["launches"],
                    "cf_train_step ukbb192 bf16 cf_remat": cft["ukbb192_remat"]["launches"],
                    "cf eval step ukbb192 bf16": cft["ukbb192_eval"]["launches"],
                    "cf_train_step mimic192 bf16": cft["mimic192"]["launches"],
                    "cf_train_step morphomnist (final_cf_morph_tw25)":
                        cft["morphomnist"]["launches"],
                    "cli.train_cf morphomnist": cft["cli"]["launches"]})
    # slice 10: the flagships' train steps with block remat (and without, at
    # bs 32), write_images on each viz cell, each stage of the e2e run
    by_path.update({f"train_step {k.replace('_', ' ')}": c
                    for k, c in rem["launches"].items()})
    by_path.update({f"write_images {n}": v["launches"] for n, v in vz.items()})
    by_path.update({f"e2e_synth_torch ukbb192 flagship stage {k}": v["launches"]
                    for k, v in e2e["stages"].items()})
    # the parallel path: each rank's data-parallel ukbb192 step and spatially sharded
    # forward (2 ranks on one card over gloo), and the NCCL world-1 step
    by_path.update(par["launches"])
    # the tail: the Morpho-MNIST train step traced through utils/profiling.py
    by_path["train_step morphomnist under profiling.trace"] = tl["profile"]["launches"]

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
            "phase K1 (injected eps at every slice shape + ragged; Philox statistics; the "
            "dense do_mask path has the slice's shapes), phase mimic (injected eps at the "
            "mimic192 path's shapes), phase vol3d (injected eps at vol3d32's (8,8,r,r,r)), "
            "phase cmnist_cf (injected eps at the Colour-MNIST path's shapes) and phase "
            "cf_train (injected eps at the ukbb192 and mimic192 CF updates' shapes, bs 16)",
            dict(k1, max_abs_err=max(k1["max_abs_err"], mim["k1_max_abs_err"],
                                     vol["k1_max_abs_err"], ccf["k1_max_abs_err"],
                                     cft["k1_max_abs_err"])),
            ms_inputs_in_l2=k1["ms_l2"], ms_philox=k1["ms_philox"],
            bound_ms_philox=k1["bound_ms_philox"]),
        row("fused_sample_kl_bwd", "causal_gen_tpu_torch/csrc/sample_kl.cu",
            "causal_gen_tpu/ops/pallas_kernels.py:136",
            "phase K1-bwd (autograd of the plain version, injected eps and Philox, every "
            "slice shape + ragged), phase vol3d (the same at vol3d32's (8,8,r,r,r), the "
            "KL's cotangent stride 0 over (D,H,W)) and phase cf_train (the same at the "
            "ukbb192 and mimic192 CF updates' shapes, bs 16)",
            dict(k1b, max_abs_err=max(k1b["max_abs_err"], vol["k1_bwd_max_abs_err"],
                                      cft["k1_bwd_max_abs_err"]))),
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
            ", ".join(map(str, K2_SHAPES)) + ", with and without biases, and phase dense_cf "
            "at the ukbb192 dense path's shapes, bs 2, with biases); ms, plain_ms, "
            "library_ms (cuDNN conv pair) and bound_ms at (32,32,192,192) b=8; times holds "
            "every ukbb192 shape; phase parallel at the spatially sharded forward's slab shapes",
            dict(k2, max_abs_err=max(k2["max_abs_err_bf16"], dcf["ukbb192"]["k2_max_abs_err"],
                                     par["k2_slab_max_abs_err"]["bfloat16"])),
            times=k2["times"], per_path=k2["per_path"]),
        row("fused_light_block_simt", "causal_gen_tpu_torch/csrc/fused_block.cu",
            "causal_gen_tpu/ops/fused_block.py:190",
            "phase K2 (float32 CUDA-core kernel, TF32 off; plain version at the same shapes and "
            "ukbb64's, with and without biases); ms, plain_ms, library_ms (cuDNN conv pair, "
            "TF32 off) and bound_ms at (32,64,32,32) b=16, the ukbb64 shape of most launches; "
            "times_ukbb64 and times_ukbb192 hold every shape; phase parallel at the spatially "
            "sharded forward's slab shapes",
            dict(k2["f32"], max_abs_err=max(k2["max_abs_err_f32"],
                                            par["k2_slab_max_abs_err"]["float32"])),
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
              "ukbb64": uk64, "mimic": mim, "cond_prior": cp, "vol3d": vol, "pgm_train": pgm,
              "dense_cf": dcf, "cmnist_cf": ccf, "simple_vae": svae, "cf_train": cft,
              "remat": rem, "viz": vz, "e2e": e2e, "parallel": par, "tail": tl, "turns": turns,
              "kernels": kernels, "phase_seconds": seconds,
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
