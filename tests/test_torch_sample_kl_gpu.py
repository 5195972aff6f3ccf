"""K1 on the card: the CUDA kernel against its plain version.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine with a card and no JAX; tests/conftest.py
imports JAX, hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sample_kl_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl, fused_sample_kl_ref

torch.set_num_threads(1)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, s, shape).astype(np.float32) for s in (1.0, 0.3, 1.0, 0.3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 16, 32, 32), (1000003,)])
def test_kernel_matches_plain_version(cuda, shape):
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(shape, seed=3)]
    eps = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    z, kl = fused_sample_kl(*args, eps=eps)
    z_r, kl_r = fused_sample_kl_ref(*args, eps)
    torch.cuda.synchronize()
    assert torch.all((z - z_r).abs() <= 1e-6 * (1 + z_r.abs()))
    assert torch.all((kl - kl_r).abs() <= 1e-6 * (1 + kl_r.abs()))


@pytest.mark.gpu
def test_kernel_philox_stream(cuda):
    zeros = torch.zeros(1 << 22, device=cuda)
    z1, _ = fused_sample_kl(zeros, zeros, zeros, zeros, generator=torch.Generator().manual_seed(1))
    z2, _ = fused_sample_kl(zeros, zeros, zeros, zeros, generator=torch.Generator().manual_seed(1))
    z3, _ = fused_sample_kl(zeros, zeros, zeros, zeros, generator=torch.Generator().manual_seed(2))
    assert abs(z1.mean().item()) < 5e-3 and abs(z1.std().item() - 1) < 5e-3
    assert torch.equal(z1, z2) and not torch.equal(z1, z3)


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs_and_backward(cuda):
    a = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        fused_sample_kl(a.t(), a.t(), a.t(), a.t())
    with pytest.raises(ValueError):
        fused_sample_kl(a, a, a, a.double())
    q = torch.zeros(4, 8, device=cuda, requires_grad=True)
    z, kl = fused_sample_kl(q, a, a, a)
    with pytest.raises(NotImplementedError):
        (z.sum() + kl.sum()).backward()
