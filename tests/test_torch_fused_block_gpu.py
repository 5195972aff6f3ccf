"""K2 on the card: both kernels (bf16 on the tensor cores, float32 on the
CUDA cores) against their plain version at every ukbb192 block shape, at
batch 1, at batches that leave a block of several images short, and at
shapes whose channels are not multiples of 16 or whose weights must be
streamed; the float32 kernel at every ukbb64 block shape; what the wrapper
refuses; and the light Block's path rule on CUDA.

Every test here needs a CUDA device and skips without one. The file imports
no JAX (tests/conftest.py does), hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_block_gpu.py -m gpu

Inputs and tolerances come from chip_smoke (k2_inputs, k2_compare): float32
within 1e-5 abs + rel with TF32 off; bf16 within one ulp of |y| plus what one
element of mid rounded the other way moves y by.
"""

import pytest
import torch

from causal_gen_tpu_torch.models.blocks import Block
from causal_gen_tpu_torch.ops.fused_block import fused_light_block, fused_light_block_ref, plan
from chip_smoke import UKBB64_K2_SHAPES, UKBB_K2_SHAPES, bf16_ulp, k2_compare, k2_inputs

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K2 kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", UKBB_K2_SHAPES + [
    (2, 32, 8, 40, 36), (1, 32, 8, 40, 36), (1, 512, 128, 1, 1),  # ragged tiles; batch 1
    (20, 512, 128, 1, 1), (5, 24, 8, 2, 3),  # several images a block, the last block short
    (3, 8, 2, 7, 13), (2, 48, 12, 9, 11),  # C and b not multiples of 16
    (2, 512, 128, 5, 4)])  # weights streamed a tap at a time
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
def test_kernel_matches_plain_version(cuda, shape, dtype, bias):
    """bf16 launches the tensor-core kernel, float32 the CUDA-core kernel,
    each once, within k2_compare's tolerance of the plain version."""
    args = k2_inputs(*shape, dtype, bias, cuda, seed=3)
    fused_light_block.launches = fused_light_block.launches_tc = 0
    fused_light_block.launches_simt = 0
    got = fused_light_block(*args)
    tc = dtype == torch.bfloat16
    assert (fused_light_block.launches, fused_light_block.launches_tc,
            fused_light_block.launches_simt) == (1, int(tc), int(not tc))
    assert plan(*shape, dtype).kernel == ("tc" if tc else "simt")
    ref = fused_light_block_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    k2_compare(args, got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", UKBB64_K2_SHAPES + [(2, 1024, 256, 1, 1), (3, 256, 64, 8, 8)])
@pytest.mark.parametrize("bias", [False, True])
def test_float32_kernel_matches_plain_version_at_ukbb64(cuda, shape, bias):
    """ukbb64's shapes (its main path runs float32), and at batches that
    leave a block of several images short: one launch of the CUDA-core
    kernel within 1e-5 abs + rel of the plain version."""
    args = k2_inputs(*shape, torch.float32, bias, cuda, seed=4)
    fused_light_block.launches = fused_light_block.launches_simt = 0
    got = fused_light_block(*args)
    assert (fused_light_block.launches, fused_light_block.launches_simt) == (1, 1)
    ref = fused_light_block_ref(*args)
    torch.cuda.synchronize()
    k2_compare(args, got, ref)


@pytest.mark.gpu
def test_wrapper_rejects_what_it_does_not_take(cuda):
    x, w1, w2, b1, b2 = k2_inputs(2, 8, 2, 5, 5, torch.float32, True, cuda)
    with pytest.raises(ValueError):
        fused_light_block(x.half(), w1.half(), w2.half())  # float16
    with pytest.raises(ValueError):
        fused_light_block(x.transpose(2, 3), w1, w2)  # not contiguous
    with pytest.raises(ValueError):
        fused_light_block(x, w1.bfloat16(), w2)  # mixed dtypes
    with pytest.raises(ValueError):
        fused_light_block(x, w1[:, :4].contiguous(), w2)  # w1 of another width
    with pytest.raises(ValueError):
        fused_light_block(x, w1, w2, b1[:1].contiguous(), b2)  # bias of another width
    with pytest.raises(ValueError):
        fused_light_block(x, w1.cpu(), w2)  # weight on another device


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_covered_block_launches_k2_outside_autograd_only(cuda, dtype):
    blk = Block(16, 4, 16, version="light", dtype=dtype).to(cuda)
    x = torch.randn(2, 16, 9, 9, device=cuda, dtype=dtype or torch.float32)
    fused_light_block.launches = 0
    with torch.inference_mode():
        y = blk(x)
    assert fused_light_block.launches == 1
    y_ops = blk(x.clone()).detach()  # autograd records: per-op convs
    assert fused_light_block.launches == 1
    # bf16: the per-op path rounds each conv's output and the residual add
    # too, so the two differ by up to ~2 ulps of the largest output
    tol = 1e-5 if dtype is None else 2 * bf16_ulp(y.float().abs().max()).item()
    assert (y.float() - y_ops.float()).abs().max().item() <= tol
