"""The port's parallel helpers, its launcher, the multi-process example
(``examples/multihost_train_torch.py``) and the dry run on gloo ranks on the
CPU.

- The launcher: every rank's result in rank order; a rank that raises fails
  the call with its traceback; a hung rank fails it after the timeout.
- On a (2 ``data``, 2 ``space``) mesh of 4 ranks: the coordinates and
  neighbours, ``host_shard_indices`` (by the mesh's ``data`` axis and by the
  world), ``make_global_batch`` (NHWC -> NCHW on the rank's device),
  ``batch_sharding``'s microbatch layout, ``replicate`` (rank 0's values
  everywhere), the halo exchange forward and backward against rows of the
  whole tensor, and the spatial gather.
- ``examples/multihost_train_torch.py --smoke`` as two processes (explicit
  coordinator flags) and as one; ``dryrun_multidevice(4)``; ``entry``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from causal_gen_tpu_torch.parallel import batch_sharding, initialize_multihost, make_mesh
from causal_gen_tpu_torch.parallel.launch import free_port, spawn

from tests import torch_dist as td

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _square(rank, world, device, k):
    return {"rank": rank, "world": world, "device": str(device), "v": np.full(2, rank * k)}


def _fails(rank, world, device):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    import torch.distributed as dist

    dist.barrier()  # would wait for rank 1 forever


def _hangs(rank, world, device):
    import time

    time.sleep(600)


def test_spawn_returns_every_rank_in_order():
    out = spawn(_square, 2, (3,), timeout=td.TIMEOUT_S)
    assert [o["rank"] for o in out] == [0, 1] and all(o["world"] == 2 for o in out)
    assert [o["device"] for o in out] == ["cpu", "cpu"]
    np.testing.assert_array_equal(out[1]["v"], [3, 3])


def test_spawn_fails_with_the_rank_traceback():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(_fails, 2, timeout=td.TIMEOUT_S)


def test_spawn_ends_a_hung_rank_at_its_timeout():
    with pytest.raises(TimeoutError, match="still running"):
        spawn(_hangs, 2, timeout=8)


def test_one_process_mesh_and_batch_rows():
    """Without a process group the mesh is one rank; the rows of a rank of
    a 2-way data axis are its share of each microbatch."""
    mesh = make_mesh()
    assert (mesh.world, mesh.rank, mesh.size("data", "model", "space")) == (1, 0, 1)
    assert mesh.group("data") is None and mesh.neighbour("space", 1) is None
    np.testing.assert_array_equal(batch_sharding(mesh, 6, microbatches=2), np.arange(6))
    with pytest.raises(ValueError, match="ranks"):
        make_mesh((2,), ("data",))


def test_initialize_multihost_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_multihost("localhost:1", 1, 0, device="cuda")


@pytest.fixture(scope="module")
def helpers():
    return spawn(td.helpers_rank, 4, timeout=td.TIMEOUT_S)


def test_mesh_coordinates_and_neighbours(helpers):
    assert [h["coords"] for h in helpers] == [
        {"data": 0, "space": 0}, {"data": 0, "space": 1},
        {"data": 1, "space": 0}, {"data": 1, "space": 1}]
    assert [h["neighbours"] for h in helpers] == [[None, 1], [0, None], [None, 3], [2, None]]


def test_host_shard_indices_and_make_global_batch(helpers):
    idx = np.arange(10, 26)
    for rank, h in enumerate(helpers):
        d = rank // 2
        np.testing.assert_array_equal(h["host_shard"], idx[8 * d:8 * d + 8])
        np.testing.assert_array_equal(h["host_shard_world"], idx[4 * rank:4 * rank + 4])
        b = h["global_batch"]
        assert b["x"].shape == (2, 1, 3, 4) and b["x"].dtype == np.uint8
        np.testing.assert_array_equal(
            b["x"], (np.arange(24, dtype=np.uint8).reshape(2, 3, 4, 1) + rank).transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(b["pa"], np.full((2, 5), rank, np.float32))


def test_batch_sharding_takes_a_share_of_each_microbatch(helpers):
    for rank, h in enumerate(helpers):
        d = rank // 2
        np.testing.assert_array_equal(h["rows_accu2"], [2 * d, 2 * d + 1, 4 + 2 * d, 5 + 2 * d])


def test_replicate_broadcasts_rank_0(helpers):
    for h in helpers:
        np.testing.assert_array_equal(h["replicated"][0], np.zeros(3))
        np.testing.assert_array_equal(h["replicated"][1], np.zeros((2, 2)))


def test_halo_and_gather_match_the_whole_tensor(helpers):
    for h in helpers:
        assert h["halo_fwd_err"] == 0.0
        assert h["halo_grad_err"] < 1e-6
        assert h["gather_err"] == 0.0


def _example(*args, env=None):
    return subprocess.Popen([sys.executable, os.path.join(ROOT, "examples",
                                                          "multihost_train_torch.py"),
                             "--smoke", "--device", "cpu", "--global_bs", "16", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


def test_multihost_example_smoke_two_processes():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = free_port()
    procs = [_example("--coordinator", f"localhost:{port}", "--num_processes", "2",
                      "--process_id", str(i), env=env) for i in range(2)]
    try:
        outs = [p.communicate(timeout=td.TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "processes=2 backend=gloo" in outs[0] and "multihost run ok" in outs[0]


def test_multihost_example_smoke_one_process():
    out, _ = _example(env=dict(os.environ, OMP_NUM_THREADS="1")).communicate(timeout=td.TIMEOUT_S)
    assert "processes=1" in out and "multihost run ok" in out, out


def test_dryrun_multidevice_4():
    from causal_gen_tpu_torch.parallel.dryrun import dryrun_multidevice

    out = dryrun_multidevice(4, device="cpu", timeout=td.TIMEOUT_S)
    assert out["mesh"] == {"data": 2, "model": 2}
    for phase in ("hvae", "cf", "ukbb192"):
        assert out[phase]["skipped"] == 0.0 and np.isfinite(out[phase]["grad_norm"]), phase


def test_dryrun_multidevice_wants_a_card_by_default():
    from causal_gen_tpu_torch.parallel.dryrun import dryrun_multidevice

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun_multidevice(2)


def test_entry_runs_on_the_cpu_and_wants_a_card_by_default():
    from causal_gen_tpu_torch.parallel.dryrun import entry

    fn, args = entry(device="cpu")
    assert np.isfinite(float(fn(*args)["elbo"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
