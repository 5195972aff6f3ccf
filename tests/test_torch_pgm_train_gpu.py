"""PGM training and the dense counterfactual on the card, against the CPU
plain path: three semi_sup updates of the Morpho-MNIST and MIMIC PGMs with
the same batches and guide draws, and DSCM.forward(do_mask=...) on
Morpho-MNIST (the card's dense rows against the CPU's and against the
sparse forward of each pattern, with K1's launches).

Every test here needs a CUDA device and skips without one. The file imports
no JAX (tests/conftest.py does), hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pgm_train_gpu.py -m gpu

Tolerances as chip_smoke.py's pgm_train and dense_cf phases: each update,
made on both from the same state, within 1e-4 rel (losses) and 2 lr
(parameters and EMA: a gradient element at its rounding may take another
sign); cf_x 1e-4, the parents 1e-5, terms 1e-4 rel (TF32 off).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from causal_gen_tpu_torch.config import get_config
from causal_gen_tpu_torch.convert import build_pgm
from causal_gen_tpu_torch.ops.sample_kl import fused_sample_kl
from causal_gen_tpu_torch.pgm.train_pgm import PGMConfig

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's path is what is held here")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["semi_sup", "semi_sup_mimic"])
def test_semi_sup_updates_card_match_cpu(cuda, name):
    cfg = dataclasses.replace(PGMConfig(**cs.PGM_SETUPS[name]), bs=16)
    model = build_pgm(cfg.to_dict(), True, "cpu", generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    batches = [(cs.pgm_batch(cfg.dataset, cfg.bs, cfg.input_res, rng),
                cs.pgm_batch(cfg.dataset, cfg.bs, cfg.input_res, rng)) for _ in range(3)]
    draws = cs.guide_draws(model, cfg.bs, rng)
    for u in cs.pgm_updates_card_vs_cpu(cfg, model.state_dict(), batches, draws):
        assert max(v for k, v in u["rel_err"].items() if k != "grad_norm") <= 1e-4, u
        assert max(u["params_max_abs_err"], u["ema_max_abs_err"]) <= 2 * cfg.lr + 1e-6, u


@pytest.mark.gpu
def test_dense_counterfactual_card_matches_cpu_and_sparse(cuda):
    cfg = get_config("morphomnist", bs=10)
    dscm = cs.build_slice(cfg, "cuda")
    rng = np.random.default_rng(3)
    obs = cs.synth_obs(cfg, cuda)
    obs = {k: v[:10] for k, v in obs.items()}
    do, mask, rows = cs.dense_do(obs, cs.DENSE_PATTERNS, rng)
    noise = cs.normals(cfg, 10, rng, passes=2)
    with torch.inference_mode():
        fused_sample_kl.launches = 0
        gpu = dscm.forward(obs, do, noise=[e.to(cuda) for e in noise], do_mask=mask)
        torch.cuda.synchronize()
        assert fused_sample_kl.launches == 2 * len(cs.k1_res(cfg))
        cpu_d = cs.build_slice(cfg, "cpu", cs.state_of(dscm.vae, dscm.pgm, dscm.predictor))
        cpu = cpu_d.forward({k: v.cpu() for k, v in obs.items()},
                            {k: v.cpu() for k, v in do.items()}, noise=noise,
                            do_mask={k: v.cpu() for k, v in mask.items()})
        assert (gpu["cfs"]["x"].cpu() - cpu["cfs"]["x"]).abs().max() <= 1e-4
        for k in do:
            assert (gpu["cfs"][k].cpu() - cpu["cfs"][k]).abs().max() <= 1e-5, k
        for k in ("elbo", "nll", "kl", "aux_loss", "loss"):
            assert float(gpu[k]) == pytest.approx(float(cpu[k]), rel=1e-4), k
        for pat in cs.DENSE_PATTERNS:
            idx = [i for i, r in enumerate(rows) if r == pat]
            sub = dscm.forward({k: v[idx] for k, v in obs.items()},
                               {k: do[k][idx] for k in pat},
                               noise=[e[idx].to(cuda) for e in noise])
            assert (sub["cfs"]["x"] - gpu["cfs"]["x"][idx]).abs().max() <= 1e-4, pat
