"""K4 on the card: the DMoL sampler kernel against its plain version, its
Philox statistics and what its wrapper refuses; and sampling with a CPU
generator on a CUDA HVAE.

Every test here needs a CUDA device and skips without one. The file imports
no JAX (tests/conftest.py does), hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dmol_sample_gpu.py -m gpu

Inputs and checks come from chip_smoke: log-scales from below the -7 floor
up, uniforms in [1e-5, 1 - 1e-5); pixels within 1e-5 of a tie between their
two best perturbed logits are left out of the comparison.
"""

import pytest
import torch

from causal_gen_tpu_torch.models.hvae import HVAE, plan_decoder_blocks
from causal_gen_tpu_torch.ops.dmol import sample_from_discretized_mix_logistic
from causal_gen_tpu_torch.ops.dmol_sample import dmol_sample
from chip_smoke import k4_compare, k4_inputs, k4_philox_stats

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K4 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 32, 32), (3, 7, 13)])
@pytest.mark.parametrize("t", [0.3, 1.0])
def test_kernel_matches_plain_version(cuda, shape, t):
    l, u_mix, u = k4_inputs(*shape, device=cuda, seed=3)
    dmol_sample.launches = 0
    got = dmol_sample(l, 10, t, u_mix=u_mix, u=u)
    assert dmol_sample.launches == 1
    ref = sample_from_discretized_mix_logistic(l, 10, t, u_mix=u_mix, u=u)
    torch.cuda.synchronize()
    excluded, _ = k4_compare(l, u_mix, t, got, ref)
    assert excluded <= 2


@pytest.mark.gpu
def test_philox_statistics(cuda):
    stats = k4_philox_stats(cuda, b=4, h=256, w=256, seed=1)
    assert stats["max_abs_z"] < 5 and stats["ks"] < 0.01
    assert stats["same_seed_repeats"] and stats["other_seed_differs"]


@pytest.mark.gpu
def test_wrapper_rejects_what_it_does_not_take(cuda):
    l, u_mix, u = k4_inputs(2, 4, 4, device=cuda)
    with pytest.raises(ValueError):
        dmol_sample(l[:, :90].contiguous(), 10)  # 9 mixtures' channels for 10
    with pytest.raises(ValueError):
        dmol_sample(l.transpose(2, 3), 10)
    with pytest.raises(ValueError):
        dmol_sample(l.double(), 10)
    with pytest.raises(ValueError):
        dmol_sample(l, 10, u_mix=u_mix)  # u_mix without u
    with pytest.raises(ValueError):
        dmol_sample(l, 10, u_mix=u_mix.cpu(), u=u)
    with pytest.raises(ValueError):
        dmol_sample(l, 10, t=0.0)


def _small_cfg(name="morphomnist", **overrides):
    from causal_gen_tpu_torch.config import get_config

    return get_config(name, bs=4, input_res=16, enc_arch="16b1d2,8b1d2,4b1d4,1b1",
                      dec_arch="1b1,4b1,8b1,16b1", widths=(8, 8, 16, 16), z_dim=4,
                      bias_max_res=16, **overrides)


@pytest.mark.gpu
def test_prior_draws_take_a_cpu_generator_on_the_card(cuda):
    """forward_latents with None latents and HVAE.sample draw their prior
    normals from a CPU generator while the model is on the card."""
    cfg = _small_cfg()
    vae = HVAE(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    n_sto = sum(1 for r, _ in plan_decoder_blocks(cfg) if r <= cfg.z_max_res)
    pa = torch.rand((4, cfg.context_dim), generator=torch.Generator().manual_seed(1)).to(cuda)
    with torch.no_grad():
        loc, scale = vae.forward_latents([None] * n_sto, pa,
                                         generator=torch.Generator().manual_seed(2))
        again, _ = vae.forward_latents([None] * n_sto, pa,
                                       generator=torch.Generator().manual_seed(2))
        x, s = vae.sample(pa, return_loc=False, t=0.5, generator=torch.Generator().manual_seed(3))
    for a in (loc, scale, x, s):
        assert a.device.type == cuda.type and a.shape == (4, 1, 16, 16) and torch.isfinite(a).all()
    assert torch.equal(loc, again)


@pytest.mark.gpu
def test_dmol_head_sample_launches_k4_once(cuda):
    cfg = _small_cfg("cmnist", x_like="diag_dmol")
    vae = HVAE(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    pa = torch.rand((4, 20), generator=torch.Generator().manual_seed(1)).to(cuda)
    dmol_sample.launches = 0
    with torch.no_grad():
        x, s = vae.sample(pa, return_loc=False, t=0.7, generator=torch.Generator().manual_seed(4))
    torch.cuda.synchronize()
    assert dmol_sample.launches == 1
    assert x.shape == (4, 3, 16, 16) and torch.isfinite(x).all() and x.abs().max() <= 1
