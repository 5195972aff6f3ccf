"""Data parallelism of the port's CF update (``pgm/train_cf.py``) and PGM
steps (``pgm/train_pgm.py``) over gloo ranks on the CPU
(``parallel/launch.py::spawn``), against one process at the same global
batch.

- CF update at world 2, ``accu_steps`` 1 and 2, ε 1.8 against an ELBO near
  6, so the damping term (100 (ε - elbo)) dominates the loss and λ moves:
  the tolerances of tests/test_parallel_pgm.py:85-115 (terms and the grad
  norm 1e-4 rel, λ 1e-5, VAE parameters 1e-4).
- PGM steps ``sup_pgm`` (a batch mean) and ``semi_sup`` (a batch sum) at
  world 2: metrics 1e-5 rel, parameters within 2 lr an update and all but
  a thousandth of them within 1e-5.

A hung rank fails its test after ``torch_dist.TIMEOUT_S``.
"""

import numpy as np
import pytest
import torch

from causal_gen_tpu_torch.parallel.launch import spawn

from tests import torch_dist as td

torch.set_num_threads(1)


def _rank(rank, world, device):
    from causal_gen_tpu_torch.parallel import make_mesh

    mesh = make_mesh((world,), ("data",))
    out = {f"cf{a}": td.run_cf_updates(accu=a, mesh=mesh) for a in (1, 2)}
    out.update({s: td.run_pgm_steps(s, mesh=mesh) for s in ("sup_pgm", "semi_sup")})
    return out


@pytest.fixture(scope="module")
def runs():
    """The one-process runs, and one spawn of 2 ranks that runs them all."""
    ref = {f"cf{a}": td.run_cf_updates(accu=a) for a in (1, 2)}
    ref.update({s: td.run_pgm_steps(s) for s in ("sup_pgm", "semi_sup")})
    return ref, {2: spawn(_rank, 2, timeout=td.TIMEOUT_S)}


@pytest.mark.parametrize("accu", [1, 2])
def test_dp_cf_update_matches_one_process(runs, accu):
    ref, par = runs[0][f"cf{accu}"], [r[f"cf{accu}"] for r in runs[1][2]]
    for got in par:
        for s, (a, b) in enumerate(zip(ref["metrics"], got["metrics"])):
            assert a["skipped"] == b["skipped"] == 0.0
            for k in ("loss", "aux_loss", "elbo", "nll", "kl", "grad_norm"):
                assert b[k] == pytest.approx(a[k], rel=1e-4), (s, k, b[k], a[k])
            assert b["lmbda"] == pytest.approx(a["lmbda"], rel=1e-5, abs=1e-8), s
        # the damping term is active: it dominates the loss, and lambda moved
        assert ref["metrics"][0]["loss"] > 100 * ref["metrics"][0]["aux_loss"]
        assert got["lmbda"] == pytest.approx(ref["lmbda"], rel=1e-5, abs=1e-8)
        assert got["lmbda"] > 0
        worst = max(float(np.abs(ref["vae"][k] - got["vae"][k]).max()) for k in ref["vae"])
        assert worst < 1e-4, worst


@pytest.mark.parametrize("setup", ["sup_pgm", "semi_sup"])
def test_dp_pgm_steps_match_one_process(runs, setup):
    ref = runs[0][setup]
    for got in (r[setup] for r in runs[1][2]):
        for s, (a, b) in enumerate(zip(ref["metrics"], got["metrics"])):
            assert sorted(a) == sorted(b)
            for k in a:
                assert b[k] == pytest.approx(a[k], rel=1e-5, abs=1e-6), (s, k, b[k], a[k])
        for tree in ("params", "ema"):
            td.assert_params_close(ref[tree], got[tree], 1e-3, len(ref["metrics"]), tree)
