"""PyTorch/CUDA port of ``causal_gen_tpu``.

Same module layout as the JAX package, so each module has a counterpart of the
same name there. Modules are NCHW ``nn.Module``s; every random draw takes an
explicit ``torch.Generator`` or an injected ``noise=`` tensor. Committed flax
checkpoints convert with ``convert.py`` (numpy trees in, ``state_dict``s
out). The TPU kernels on the ported paths (the Morpho-MNIST counterfactual
forward, the HVAE train step, sampling at a temperature, the ukbb192 and
ukbb64 slices, the mimic192 counterfactual forward and the counterfactual
fine-tune) are CUDA C++ kernels built with ``nvcc`` on first use: ``fused_sample_kl`` and its
backward (``csrc/sample_kl.cu``), the DMoL loss, forward and backward
(``csrc/dmol_loss.cu``), the DMoL sampler (``csrc/dmol_sample.cu``) and the
fused light block (``csrc/fused_block.cu``).

The package imports ``torch``, ``numpy`` and, for the morphometric
measurements (``eval/morphometrics.py``), ``scipy``: never ``jax``, ``flax``,
``orbax`` or ``causal_gen_tpu``.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on. Raises when CUDA is asked for and
    there is no GPU: nothing carries on on the CPU unless the caller passes
    ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "causal_gen_tpu_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run the plain PyTorch path on the CPU'
        )
    return device
