"""Tensor and spatial parallelism of the port's HVAE (``parallel/tensor.py``,
``parallel/spatial.py``) over gloo ranks on the CPU, against one process.

- TP rule: ``param_partition_spec`` picks the torch counterparts (by the
  converter's names) of exactly the flax kernels that JAX's rule picks, on
  every registry HVAE.
- TP at (1 ``data``, 2 ``model``), the tiny HVAE split from 8 out channels:
  forward and gradients (each sharded weight's gathered) 1e-5 rel of the
  tensor's largest, two updates' metrics 1e-5 rel and parameters within 2
  lr an update, all but a thousandth of them within 1e-5; a layer whose
  out channels do not split evenly stays replicated and the module's
  output is one process's; a checkpoint written by the sharded run holds
  whole tensors, loads into one process and takes the same next update,
  and loads back into a sharded run, which takes it too.
- SP at (2 ``data``, 2 ``space``), and with TP at (1 ``data``, 2
  ``model``, 2 ``space``): two train steps' ELBO within 1e-3 rel
  and the abduction latents within 1e-5 abs, JAX's tolerances and reasons
  (tests/test_train.py:449-476); the steps' grad_norm 1e-5 rel and
  parameters as the TP check's, and one batch's ELBO and reduced
  gradients 1e-5 rel of one process's (the halo, gather and sum
  adjoints), on the tiny HVAE (GELU blocks) and on its
  light-block twin, whose forward outside autograd takes K2 (its plain
  version here) with a two-row halo on every covered block; a 3-D forward's
  NLL within 1e-4 rel (tests/test_hvae3d.py:184) on tiny3d.
"""

import jax
import numpy as np
import pytest
import torch

from causal_gen_tpu.config import get_config as jget_config
from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.parallel.mesh import param_partition_spec as jspec
from causal_gen_tpu_torch.config import get_config
from causal_gen_tpu_torch.convert import params_from_jax
from causal_gen_tpu_torch.parallel import param_partition_spec
from causal_gen_tpu_torch.parallel.launch import spawn
from causal_gen_tpu_torch.train.checkpoint import restore_train_state
from causal_gen_tpu_torch.train.vae_trainer import train_step

from tests import torch_dist as td
from tests.torch_parity import to_numpy

torch.set_num_threads(1)

REGISTRY_HVAES = ("morphomnist", "cmnist", "ukbb64", "ukbb192", "mimic192", "vol3d32")


@pytest.mark.parametrize("name", REGISTRY_HVAES)
def test_param_partition_spec_picks_the_layers_jax_picks(name):
    """Each flax leaf marked 1 where JAX's rule shards it, converted to torch
    names; the port's rule must pick exactly the marked weights."""
    jcfg = jget_config(name)
    jvae = JHVAE(cfg=jcfg)
    x = jax.numpy.zeros((1,) + (jcfg.input_res,) * jcfg.spatial_dims + (jcfg.input_channels,))
    pa = jax.numpy.zeros((1, jcfg.context_dim))
    shapes = jax.eval_shape(lambda k: jvae.init({"params": k, "sample": k}, x, pa,
                                                beta=jcfg.beta, train=False)["params"],
                            jax.random.PRNGKey(0))
    marks = jax.tree_util.tree_map_with_path(
        lambda path, s: np.full(s.shape, float(jspec(path, s) != jax.sharding.PartitionSpec()),
                                np.float32), shapes)
    jax_picks = {k for k, v in params_from_jax(to_numpy(marks)).items() if bool(v.all())}
    model = _meta_hvae(get_config(name))
    port_picks = {k for k, p in model.named_parameters() if param_partition_spec(k, p)}
    assert bool(jax_picks) == (max(jcfg.widths) >= 256), name  # vol3d32 is 8-64 wide
    assert port_picks == jax_picks


def _meta_hvae(cfg):
    """The port's HVAE modules of ``cfg`` (its parameters' names and shapes)
    on the meta device: no memory, no init."""
    with torch.device("meta"):
        from causal_gen_tpu_torch.models.blocks import Encoder
        from causal_gen_tpu_torch.models.hvae import Decoder, compute_dtype
        from causal_gen_tpu_torch.models.likelihoods import make_likelihood

        m = torch.nn.Module()
        m.encoder = Encoder(cfg.enc_stages, cfg.model_widths, cfg.bottleneck,
                            cfg.input_channels, cfg.block_version, compute_dtype(cfg),
                            cfg.spatial_dims)
        m.decoder = Decoder(cfg)
        m.likelihood = make_likelihood(cfg.input_channels, cfg.model_widths[0], cfg.x_like,
                                       cfg.std_init, cfg.spatial_dims)
    return m


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    cfg = td.tiny_cfg(lr_warmup_steps=0)
    steps = td.hvae_inputs(cfg, 2, seed=3)
    path = str(tmp_path_factory.mktemp("tp") / "step_1.pt")
    ranks = spawn(td.tp_rank, 2, (cfg, steps, path), timeout=td.TIMEOUT_S)
    ref = {"steps": td.run_hvae_steps(cfg, steps),
           "loss_grads": td.hvae_loss_grads(cfg, steps[0]), "uneven": td.uneven_module()[1]}
    return cfg, steps, path, ref, ranks


def test_tp_forward_and_gradients_match_one_process(tp_runs):
    cfg, _, _, ref, ranks = tp_runs
    for got in ranks:
        assert got["n_sharded"] > 10  # most of tiny_cfg's convs are split
        a, b = ref["loss_grads"], got["loss_grads"]
        assert b["elbo"] == pytest.approx(a["elbo"], rel=1e-5)
        td.assert_grads_match(a["grads"], b["grads"])


def test_tp_updates_match_one_process(tp_runs):
    cfg, _, _, ref, ranks = tp_runs
    for got in ranks:
        for s, (a, b) in enumerate(zip(ref["steps"]["metrics"], got["steps"]["metrics"])):
            for k in ("elbo", "nll", "kl", "grad_norm"):
                assert b[k] == pytest.approx(a[k], rel=1e-5), (s, k)
        for tree in ("params", "ema"):
            td.assert_params_close(ref["steps"][tree], got["steps"][tree], cfg.lr, 2, tree)


def test_tp_replicates_an_uneven_layer(tp_runs):
    ref, ranks = tp_runs[3], tp_runs[4]
    for got in ranks:
        u = got["uneven"]
        assert u["classes"] == ["ColumnParallelConv2d", "Conv2d", "Flatten",
                                "ColumnParallelLinear"]
        assert u["weights"] == [(3, 4, 3, 3), (5, 6, 1, 1), (4, 80)]
        np.testing.assert_allclose(u["out"], ref["uneven"], rtol=1e-6, atol=1e-6)


def test_tp_checkpoint_loads_into_one_process_and_back(tp_runs):
    cfg, steps, path, _, ranks = tp_runs
    _, payload, _ = _load(path)
    model = td.build_hvae(cfg, seed=2)  # other weights: the payload must replace them all
    for k, v in payload["params"].items():  # whole tensors
        assert tuple(v.shape) == tuple(model.state_dict()[k].shape), k
    state = restore_train_state(cfg, model, payload)
    st = steps[1]
    m = train_step(cfg, state, {"x": torch.from_numpy(st["x"]), "pa": torch.from_numpy(st["pa"])},
                   noise=[[torch.from_numpy(e) for e in mb] for mb in st["noise"]])
    params = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    for got in ranks:
        ck = got["checkpoint"]
        for run in (ck["next"], ck["restored_next"]):
            for k in ("elbo", "nll", "kl", "grad_norm"):
                assert run[k] == pytest.approx(float(m[k]), rel=1e-5), k
        for tree in (ck["params"], ck["restored_params"]):
            td.assert_params_close(params, tree, cfg.lr, 1)


def _load(path):
    from causal_gen_tpu_torch.train.checkpoint import load_checkpoint

    return load_checkpoint(path)


@pytest.fixture(scope="module")
def sp_runs():
    return td.run_sp_checks(), spawn(td.sp_rank, 4, timeout=td.TIMEOUT_S)


@pytest.mark.parametrize("name", ["tiny", "light", "vol3d", "tiny_tp"])
def test_sp_train_steps_match_one_process(sp_runs, name):
    """(2 data, 2 space); "tiny_tp": (1 data, 2 model, 2 space), the tiny
    HVAE split from 8 out channels as well."""
    ref, ranks = sp_runs
    want = ref["tiny" if name == "tiny_tp" else name]["steps"]
    for got in ranks:
        for s, (a, b) in enumerate(zip(want["metrics"], got[name]["steps"]["metrics"])):
            assert b["elbo"] == pytest.approx(a["elbo"], rel=1e-3), (s, b["elbo"], a["elbo"])
            assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-5), s
        for tree in ("params", "ema"):
            td.assert_params_close(want[tree], got[name]["steps"][tree], 1e-3,
                                   len(want["metrics"]), tree)


@pytest.mark.parametrize("name", ["tiny", "light", "vol3d", "tiny_tp"])
def test_sp_gradients_match_one_process(sp_runs, name):
    """The ELBO and its gradients on one batch, reduced over the ranks as
    the train step reduces them (halo, gather and sum adjoints; bias and
    draw slabs), against one process: 1e-5 rel."""
    ref, ranks = sp_runs
    a = ref["tiny" if name == "tiny_tp" else name]["loss_grads"]
    for got in ranks:
        b = got[name]["loss_grads"]
        assert b["elbo"] == pytest.approx(a["elbo"], rel=1e-5)
        td.assert_grads_match(a["grads"], b["grads"])


@pytest.mark.parametrize("name", ["tiny", "light"])
def test_sp_abduction_matches_one_process(sp_runs, name):
    ref, ranks = sp_runs
    for got in ranks:
        assert len(got[name]["abduct"]) == len(ref[name]["abduct"])
        for a, b in zip(ref[name]["abduct"], got[name]["abduct"]):
            assert a.shape == b.shape
            assert float(np.abs(a - b).max()) < 1e-5


def test_sp_forward_takes_k2_with_a_halo(sp_runs):
    """Outside autograd the light blocks take K2 on every rank, as in one
    process, and the ELBO terms agree."""
    ref, ranks = sp_runs
    assert ref["light"]["forward"]["k2_calls"] > 0
    assert ref["tiny"]["forward"]["k2_calls"] == 0  # GELU blocks: K2 covers none
    for got in ranks:
        assert got["light"]["forward"]["k2_calls"] == ref["light"]["forward"]["k2_calls"]
        for k in ("elbo", "nll", "kl"):
            assert got["light"]["forward"][k] == pytest.approx(ref["light"]["forward"][k],
                                                               rel=1e-4), k


def test_sp_3d_forward_nll_matches_one_process(sp_runs):
    ref, ranks = sp_runs
    for got in ranks:
        assert got["vol3d"]["forward"]["nll"] == pytest.approx(ref["vol3d"]["forward"]["nll"],
                                                               rel=1e-4)
