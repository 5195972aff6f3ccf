"""The port's profiling hooks (causal_gen_tpu_torch/utils/profiling.py) and
the twins of the profiling tools (tools/trace_ops_torch.py,
tools/device_time_torch.py) on the CPU: trace writes a Chrome trace; the
reader attributes each op to its nested annotate scopes and counts a host
op's self time once; on a trace in the CUDA form (written here in the
profiler's format) it reads the kernels and attributes them through their
launches; a CPU run has no device time and says so; StepTimer gives JAX's
mean_ms and throughput on the same recorded durations (1e-12 rel)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from causal_gen_tpu.utils import profiling as jprofiling
from causal_gen_tpu_torch.utils import profiling
from tools import device_time_torch, trace_ops_torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trace"))
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((96, 96)).astype(np.float32))
    with profiling.trace(d):
        with profiling.annotate("outer"):
            y = a @ a
            with profiling.annotate("inner"):
                z = torch.relu(y)
        z.sum()
    return d


def test_trace_writes_a_chrome_trace_on_the_cpu(cpu_trace):
    files = trace_ops_torch.trace_files(cpu_trace)
    assert len(files) == 1 and files[0].endswith(profiling.TRACE_SUFFIX)
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert "cpu_op" in cats and "user_annotation" in cats
    assert not cats & set(trace_ops_torch.DEVICE_CATS)


def test_reader_attributes_ops_to_nested_scopes(cpu_trace):
    ops = trace_ops_torch.read_ops(cpu_trace)
    assert ops and not any(op.device for op in ops)
    scopes = {op.name: op.scopes for op in ops}
    assert scopes["aten::mm"] == ("outer",)
    assert scopes["aten::relu"] == ("outer", "inner")
    assert scopes["aten::sum"] == ()
    s = trace_ops_torch.summarize(ops)
    by_scope = dict(s["by_scope"])
    assert set(by_scope) == {"outer", "inner", "(no scope)"}
    assert sum(by_scope.values()) == pytest.approx(s["total_us"], rel=1e-9)


def test_reader_counts_a_host_op_once(cpu_trace):
    """Self times: aten::matmul holds aten::mm, whose time is not counted
    again in matmul's; the self times of the ops add up to the outermost
    ops' durations."""
    (path,) = trace_ops_torch.trace_files(cpu_trace)
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    selfs = trace_ops_torch._self_times(ev)
    matmul = next(e for e in ev if e["name"] == "aten::matmul")
    inside = [e for e in ev if e is not matmul and e["tid"] == matmul["tid"]
              and matmul["ts"] <= e["ts"] <= matmul["ts"] + matmul["dur"]]
    assert selfs[id(matmul)] < matmul["dur"]
    assert sum(selfs[id(e)] for e in [matmul] + inside) == pytest.approx(matmul["dur"], abs=1e-6)
    assert all(v >= -1e-6 for v in selfs.values())


def cuda_form_trace(path):
    """A trace in the profiler's CUDA form: host annotations and launches,
    device kernels with the launches' correlation ids, a backward launched
    from another thread inside the caller's scope, a kernel whose launch is
    missing (placed by the device-side annotation), and a copy after the
    scope (the sync)."""
    pid, dev = 11, 0
    x = lambda cat, name, ts, dur, p=pid, t=1, **args: {  # noqa: E731
        "ph": "X", "cat": cat, "name": name, "pid": p, "tid": t, "ts": ts, "dur": dur,
        "args": args}
    ev = [x("user_annotation", "train_step", 0, 100),
          x("user_annotation", "decoder", 10, 20),
          x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
          x("cuda_runtime", "cudaLaunchKernel", 35, 2, correlation=2),
          x("cuda_runtime", "cudaLaunchKernel", 60, 2, t=2, correlation=3),  # backward thread
          x("cuda_runtime", "cudaMemcpyAsync", 150, 3, correlation=5),
          x("kernel", "sample_kl_kernel(float const*)", 40, 6.5, p=dev, t=7, correlation=1),
          x("kernel", "aten::conv", 47, 10.0, p=dev, t=7, correlation=2),
          x("kernel", "sample_kl_backward_kernel(float const*)", 70, 8.5, p=dev, t=7,
            correlation=3),
          x("gpu_user_annotation", "train_step", 40, 60, p=dev, t=7),
          x("kernel", "no_launch_kernel", 90, 1.0, p=dev, t=7, correlation=4),
          x("gpu_memcpy", "Memcpy DtoH", 160, 2.0, p=dev, t=7, correlation=5)]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_reader_reads_the_cuda_form(tmp_path):
    cuda_form_trace(str(tmp_path / f"host_1.1{profiling.TRACE_SUFFIX}"))
    ops = trace_ops_torch.read_ops(str(tmp_path))
    assert all(op.device for op in ops) and len(ops) == 5
    scopes = {op.name.split("(")[0]: op.scopes for op in ops}
    assert scopes["sample_kl_kernel"] == ("train_step", "decoder")
    assert scopes["aten::conv"] == ("train_step",)
    assert scopes["sample_kl_backward_kernel"] == ("train_step",)
    assert scopes["no_launch_kernel"] == ("train_step",)
    assert scopes["Memcpy DtoH"] == ()
    s = trace_ops_torch.summarize(ops)
    assert s["device"] and s["total_us"] == pytest.approx(28.0)
    assert dict(s["by_scope"]) == pytest.approx({"decoder": 6.5, "train_step": 19.5,
                                                 "(no scope)": 2.0})
    # the device time of the scope: its kernels at any depth, not the sync's copy,
    # and never the annotation spans
    assert device_time_torch.scope_ms(str(tmp_path), "train_step") == pytest.approx(0.026)
    assert device_time_torch.scope_ms(str(tmp_path), "decoder") == pytest.approx(0.0065)


def test_a_cpu_run_has_no_device_time(cpu_trace):
    with pytest.raises(RuntimeError, match="no device events"):
        device_time_torch.scope_ms(cpu_trace, "outer")
    with pytest.raises(RuntimeError, match="no device events"):
        device_time_torch.device_ms_per_iter(lambda i: torch.ones(4) * i, iters=2,
                                             windows=1, scope="op")
    with pytest.raises(ValueError):
        device_time_torch.device_ms_per_iter(lambda i: None, scope="")


def test_trace_ops_cli_prints_the_breakdown(cpu_trace):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_ops_torch.py"),
                          cpu_trace, "--top", "5"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "host op self time" in out.stdout and "aten::mm" in out.stdout
    assert "scope rollup" in out.stdout and "outer" in out.stdout


class Clock:
    """Stands in for a profiling module's ``time``: perf_counter reads the ticks."""

    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def perf_counter(self):
        return next(self.ticks)


@pytest.mark.parametrize("skip_first", [0, 2, 5])
def test_step_timer_matches_jax(monkeypatch, skip_first):
    durations = np.random.default_rng(skip_first).uniform(0.001, 0.2, 6)
    ticks = np.stack([np.arange(6) * 10.0, np.arange(6) * 10.0 + durations], 1).ravel()
    timers = {}
    for name, mod in (("jax", jprofiling), ("torch", profiling)):
        monkeypatch.setattr(mod, "time", Clock(ticks.tolist()))
        t = mod.StepTimer(skip_first=skip_first)
        dts = []
        for _ in range(6):
            t.start()
            dts.append(t.stop())
        np.testing.assert_allclose(dts, durations, rtol=1e-12)
        timers[name] = t
    j, t = timers["jax"], timers["torch"]
    assert t.times == j.times and len(t.times) == max(6 - skip_first, 0)
    assert t.mean_ms == pytest.approx(j.mean_ms, rel=1e-12)
    assert t.throughput(32) == pytest.approx(j.throughput(32), rel=1e-12)
    if skip_first >= 6:
        assert t.mean_ms == 0.0 and t.throughput(32) == 0.0


def test_step_timer_takes_a_result_on_the_cpu():
    t = profiling.StepTimer(skip_first=0)
    t.start()
    t.stop({"loss": torch.ones(2), "parts": [torch.zeros(1), (torch.ones(1), 3)]})
    assert len(t.times) == 1 and t.times[0] >= 0
