"""The parallel path on the card: two gloo ranks on one CUDA device (NCCL
refuses two ranks on one card) and NCCL at world 1, against one process.

Every test here needs a CUDA device and skips without one. The file imports
no JAX (tests/conftest.py does), hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_gpu.py -m gpu

Checks, on the tiny Morpho-MNIST HVAE and its light-block twin (float32,
TF32 off): the data-parallel step at world 2 (metrics 1e-4 rel, parameters
within 2 lr and all but a thousandth within 1e-5), the tensor- and
spatially parallel steps (the same bounds; spatial ELBO 1e-3 rel, JAX's),
the spatially sharded forward outside autograd with K2's launches a rank
equal to one process's, and NCCL at world 1 through the mesh path; the
ranks' bodies are chip_smoke.py's parallel phase's.
"""

import pytest
import torch

import chip_smoke as cs
from causal_gen_tpu_torch.parallel.launch import spawn

from tests import torch_dist as td


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's path is what is held here")
    from causal_gen_tpu_torch.ops.build import build_all

    build_all()  # once, before the ranks start
    return torch.device("cuda")


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_match_one_process(cuda):
    ranks = spawn(cs.parallel_rank, 2,
                  (td.tiny_cfg(bs=8, dtype="bfloat16"), td.tiny_cfg(bs=4, lr_warmup_steps=0),
                   td.light_cfg(bs=4, dtype="bfloat16")),
                  device="cuda", backend="gloo", timeout=300)
    r0 = ranks[0]
    assert r0["backend"] == "gloo" and r0["device"].startswith("cuda")
    for name in ("dp_f32", "tp_f32", "sp_f32"):
        assert r0[name]["param_err"] <= 2e-3, name
        n_over, n = r0[name]["params_over_1e-5"]
        assert n_over <= 1e-3 * n, (name, n_over, n)
    n_sto = len(cs.k1_res(td.tiny_cfg()))
    for r in ranks:
        assert r["dp_bf16"]["launches"]["fused_sample_kl"] == n_sto
        assert r["dp_bf16"]["launches"]["fused_sample_kl_bwd"] == n_sto
        assert r["sp_forward_bf16"]["launches"]["fused_light_block"] > 0


@pytest.mark.gpu
def test_nccl_at_world_1_runs_the_mesh_path(cuda):
    out = spawn(cs.nccl_rank, 1, (td.tiny_cfg(bs=8),), device="cuda", backend="nccl",
                timeout=300)[0]
    assert out["backend"] == "nccl"
    assert out["launches"]["fused_sample_kl"] == len(cs.k1_res(td.tiny_cfg()))
