"""HVAE block remat on the card: at the ukbb192 flagship's remat
configuration (stage_scan, remat from 48^2 up) in float32, TF32 off and
cuDNN deterministic, one ELBO's gradients with remat on equal those with
remat off within 1e-6 of each tensor's largest value, with injected draws
and with a CPU generator (K1's Philox seed replayed); the step launches K1
once more for each stochastic block of a rematerialised cell, K1-bwd once a
block, and never K2 (autograd records in the first run too). Also at
mimic192's (remat everywhere).

Every test here needs a CUDA device and skips without one. The file imports
no JAX (tests/conftest.py does), hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_remat_gpu.py -m gpu
"""

import pytest
import torch

import chip_smoke as cs

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's path is what is held here")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["injected", "generator"])
@pytest.mark.parametrize("name", ["ukbb192", "mimic192"])
def test_remat_gives_the_same_gradients_on_the_card(cuda, name, source):
    cfg = cs.remat_config(name, "float32", cs.CHECK_BS)
    r = cs.remat_grads(cfg, cs.CHECK_BS, source, seed=11)
    assert r["max_rel_err"] <= 1e-6
    assert r["launches_on"] == cs.remat_expected(cfg)
    assert r["launches_off"] == cs.expected_counts(cfg, 1)
    assert r["launches_on"]["fused_sample_kl"] > r["launches_off"]["fused_sample_kl"]
    assert r["launches_on"]["fused_light_block"] == 0


@pytest.mark.gpu
def test_remat_step_card_matches_cpu(cuda):
    rel = cs.remat_step_card_vs_cpu(cs.remat_config("ukbb192", "float32", cs.CHECK_BS), seed=12)
    assert max(rel.values()) <= 1e-4, rel
