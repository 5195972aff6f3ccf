"""K1 on the card: the CUDA kernels, forward and backward, against their
plain versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine with a card and no JAX; tests/conftest.py
imports JAX, hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sample_kl_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from causal_gen_tpu_torch.ops.sample_kl import (
    fused_sample_kl,
    fused_sample_kl_bwd,
    fused_sample_kl_ref,
)

torch.set_num_threads(1)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, s, shape).astype(np.float32) for s in (1.0, 0.3, 1.0, 0.3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda")


# vol3d32's posterior shapes (B, z, r, r, r): the 1^3 volume, a middle one and
# the largest, 2.1M elements
VOL3D = [(8, 8, 1, 1, 1), (8, 8, 8, 8, 8), (8, 8, 32, 32, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 16, 32, 32), (1000003,)] + VOL3D)
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
    """Bad inputs raise; the backward launches its kernel (it raised before
    the backward was ported)."""
    a = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        fused_sample_kl(a.t(), a.t(), a.t(), a.t())
    with pytest.raises(ValueError):
        fused_sample_kl(a, a, a, a.double())
    with pytest.raises(ValueError):
        fused_sample_kl_bwd(a, a, a, a, a, a.double(), None)
    q = torch.zeros(4, 8, device=cuda, requires_grad=True)
    z, kl = fused_sample_kl(q, a, a, a)
    fused_sample_kl_bwd.launches = 0
    (z.sum() + kl.sum()).backward()
    assert fused_sample_kl_bwd.launches == 1
    torch.cuda.synchronize()
    assert torch.equal(q.grad, torch.ones_like(q))  # gz = 1, and d kl / d q_loc = 0 here


def _grads(fn, args, eps, w, v):
    """Cotangents of the inputs under (z * w).sum() + (kl summed over space * v).sum(),
    so that d/dkl reaches the backward as the stride-0 broadcast the HVAE gives."""
    leaves = [a.clone().requires_grad_() for a in args]
    z, kl = fn(*leaves, eps)
    red = kl.sum(dim=tuple(range(2, kl.dim()))) if kl.dim() > 2 else kl
    loss = (z * w).sum() + (red * v).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 16, 32, 32), (32, 16, 1, 1), (1000003,)] + VOL3D)
@pytest.mark.parametrize("philox", [False, True])
def test_backward_matches_autograd_of_plain_version(cuda, shape, philox):
    """The backward kernel against autograd through fused_sample_kl_ref given
    the same eps (recovered from z on the Philox path): 1e-5 (1 + |ref|). On
    a volume the KL's cotangent is a stride-0 broadcast over (D, H, W)."""
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(shape, seed=4)]
    g = torch.Generator().manual_seed(1)
    w = torch.randn(shape, generator=g).to(cuda)
    v = torch.randn(shape[:2] if len(shape) > 2 else shape, generator=g).to(cuda)
    if philox:
        z, _ = fused_sample_kl(*args, generator=torch.Generator().manual_seed(3))
        eps = (z - args[0]) / torch.exp(args[1])
        kernel = _grads(lambda *a: fused_sample_kl(*a[:4], generator=torch.Generator()
                                                   .manual_seed(3)), args, None, w, v)
    else:
        eps = torch.randn(shape, generator=g).to(cuda)
        kernel = _grads(lambda *a: fused_sample_kl(*a[:4], eps=a[4]), args, eps, w, v)
    plain = _grads(lambda *a: fused_sample_kl_ref(*a[:4], a[4]), args, eps, w, v)
    torch.cuda.synchronize()
    for got, ref in zip(kernel, plain):
        assert torch.all((got - ref).abs() <= 1e-5 * (1 + ref.abs())), \
            (got - ref).abs().max().item()


@pytest.mark.gpu
def test_backward_reads_a_volume_cotangent_per_row(cuda):
    """The KL summed over (D, H, W), as the 3-D HVAE sums it, gives the
    backward a cotangent of strides (C, 1, 0, 0, 0): the kernel reads its
    (B, C) values (``_per_row``) and agrees with the materialised map."""
    from causal_gen_tpu_torch.ops.sample_kl import _per_row

    shape = VOL3D[-1]
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(shape, seed=7)]
    z, _ = fused_sample_kl(*args, eps=torch.zeros(shape, device=cuda))
    v = torch.randn(shape[:2], generator=torch.Generator().manual_seed(2)).to(cuda)
    gkl = v[:, :, None, None, None].expand(shape)
    vals, rep = _per_row(gkl)
    assert rep == 32 ** 3 and torch.equal(vals, v)
    got = fused_sample_kl_bwd(*args, z, None, gkl)
    ref = fused_sample_kl_bwd(*args, z, None, gkl.contiguous())
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
