"""K3 on the card: the DMoL loss kernels, forward and backward, against the
plain op and its autograd.

Every test here needs a CUDA device and skips without one. The file imports
no JAX (tests/conftest.py does), hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dmol_gpu.py -m gpu

Inputs come from chip_smoke.k3_inputs: x on the 8-bit grid with forced -1
and 1 pixels, log-scales from below the -7 floor up, and a column of pixels
on both sides of the 1e-5 switch.
"""

import pytest
import torch

from causal_gen_tpu_torch.ops.dmol import discretized_mix_logistic_loss, dmol_logprob_pixels
from causal_gen_tpu_torch.ops.dmol_loss import dmol_logprob, dmol_loss, dmol_loss_bwd
from chip_smoke import k3_grad_close, k3_inputs

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K3 kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("low_bit", [False, True])
@pytest.mark.parametrize("shape", [(32, 32, 32), (3, 7, 13)])
def test_forward_matches_plain_version(cuda, shape, low_bit):
    x, l = k3_inputs(*shape, device=cuda)
    got, ref = dmol_logprob(x, l, low_bit), dmol_logprob_pixels(x, l, low_bit)
    torch.cuda.synchronize()
    assert torch.all((got - ref).abs() <= 1e-5 * (1 + ref.abs()))
    loss, ref_loss = dmol_loss(x, l, low_bit), discretized_mix_logistic_loss(x, l, low_bit)
    assert torch.all((loss - ref_loss).abs() <= 1e-5 * (1 + ref_loss.abs()))


@pytest.mark.gpu
@pytest.mark.parametrize("low_bit", [False, True])
@pytest.mark.parametrize("shape", [(32, 32, 32), (3, 7, 13)])
def test_backward_matches_autograd_of_plain_version(cuda, shape, low_bit):
    x, l = k3_inputs(*shape, device=cuda)
    g = torch.randn(shape[0], generator=torch.Generator().manual_seed(1)).to(cuda)
    leaf = l.clone().requires_grad_()
    (discretized_mix_logistic_loss(x, leaf, low_bit) * g).sum().backward()
    leaf_k = l.clone().requires_grad_()
    dmol_loss_bwd.launches = 0
    (dmol_loss(x, leaf_k, low_bit) * g).sum().backward()
    assert dmol_loss_bwd.launches == 1
    torch.cuda.synchronize()
    assert k3_grad_close(leaf_k.grad, leaf.grad)
    assert k3_grad_close(dmol_loss_bwd(x, l, g, low_bit), leaf.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 32, 32), (3, 7, 13)])
def test_two_calls_agree_bit_for_bit(cuda, shape):
    """No atomics: the per-pixel sums run in one order on every call."""
    x, l = k3_inputs(*shape, device=cuda)
    g = torch.randn(shape[0], generator=torch.Generator().manual_seed(2)).to(cuda)
    assert torch.equal(dmol_logprob(x, l), dmol_logprob(x, l))
    assert torch.equal(dmol_loss_bwd(x, l, g), dmol_loss_bwd(x, l, g))


@pytest.mark.gpu
def test_each_call_launches_once(cuda):
    x, l = k3_inputs(4, 8, 8, device=cuda)
    g = torch.ones(4, device=cuda)
    dmol_logprob.launches = dmol_loss_bwd.launches = 0
    for n in (1, 2):
        dmol_logprob(x, l)
        dmol_loss_bwd(x, l, g)
        assert (dmol_logprob.launches, dmol_loss_bwd.launches) == (n, n)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(5, 9, 11), (1, 2, 1), (2, 3, 30)])
def test_ragged_pixel_counts_match_plain_version(cuda, shape):
    """Pixel counts that are no multiple of either tile (495, 2, 180): a
    ragged last tile, and tiles that straddle images."""
    b, h, w = shape
    assert (b * h * w) % 32
    x, l = k3_inputs(*shape, device=cuda)
    got, ref = dmol_logprob(x, l), dmol_logprob_pixels(x, l)
    g = torch.randn(b, generator=torch.Generator().manual_seed(3)).to(cuda)
    leaf = l.clone().requires_grad_()
    (discretized_mix_logistic_loss(x, leaf) * g).sum().backward()
    torch.cuda.synchronize()
    assert torch.all((got - ref).abs() <= 1e-5 * (1 + ref.abs()))
    assert k3_grad_close(dmol_loss_bwd(x, l, g), leaf.grad)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, l = k3_inputs(2, 4, 4, device=cuda)
    with pytest.raises(ValueError):
        dmol_loss(x.requires_grad_(), l)
    x = x.detach()
    with pytest.raises(ValueError):
        dmol_loss(x, l[:, :90].contiguous())  # 9 mixtures: the kernel has 10
    with pytest.raises(ValueError):
        dmol_loss(x, l.transpose(2, 3))
    with pytest.raises(ValueError):
        dmol_loss(x.double(), l)
    with pytest.raises(ValueError):
        dmol_loss_bwd(x, l, torch.ones(3, device=cuda))
