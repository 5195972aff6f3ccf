"""Counterfactual fine-tuning on the card: remat on against off (the
recompute replays the generator's state, so K1's Philox seeds and every
draw are the same: gradients within 1e-6 of each tensor's largest value,
the generator left where a run without remat leaves it, K1 launched again
in each recompute), and the CF update card against the CPU plain path from
one state (terms 1e-4 rel, λ 1e-5, parameters and EMA within 2 lr; TF32
off), on the registry's morphomnist with the soft-morphometry terms.

Every test here needs a CUDA device and skips without one. The file imports
no JAX (tests/conftest.py does), hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cf_gpu.py -m gpu
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
@pytest.mark.parametrize("bs", [8, 32])
def test_remat_gives_the_same_gradients_on_the_card(cuda, bs):
    r = cs.cf_remat_grads("morphomnist", cs.cf_config("morphomnist"), bs, seed=bs)
    assert r["max_rel_err"] <= 1e-6
    n_sto = len(cs.k1_res(cs.cf_dscm("morphomnist", cs.cf_config("morphomnist"), "cpu").cfg))
    assert r["launches_off"]["fused_sample_kl"] == 2 * n_sto
    assert r["launches_on"]["fused_sample_kl"] == 4 * n_sto
    assert r["launches_on"]["fused_sample_kl_bwd"] == r["launches_off"]["fused_sample_kl_bwd"]


@pytest.mark.gpu
def test_cf_updates_card_match_cpu(cuda):
    ups = cs.cf_updates_card_vs_cpu("morphomnist", cs.cf_config("morphomnist"), 2, 8, seed=5)
    for u in ups:
        assert max(u["rel_err"].values()) <= 1e-4, u
        assert u["params_ema_max_abs_err"] <= 2e-4 + 1e-6, u
