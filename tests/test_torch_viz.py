"""The port's visualisation grid against the JAX package's.

``utils/viz.py::make_cf_parents`` is exact for every dataset. ``write_images``
on the small Morpho-MNIST HVAE (float32, the same converted weights, batch
and draws) gives JAX's grid within 1 in uint8: each image row within 1, each
difference row (an int16 difference wrapped into uint8) within 1 modulo 256,
at ``n_latents_viz`` 0 and 2, with and without ``cond_prior``. The JAX side
runs under ``jax.disable_jit()`` so that its patched ``sample_gaussian``
draws at every call (a jitted viz program would draw once, at trace time);
the port takes the recorded draws in the same order (the order
``chip_smoke.py::viz_noise`` makes them in for the card's check). The PNG
holds the grid.
"""

import jax
import numpy as np
import pytest
import torch

from causal_gen_tpu.config import get_config as jget_config
from causal_gen_tpu.models.hvae import HVAE as JHVAE
from causal_gen_tpu.utils import viz as jviz
from causal_gen_tpu_torch.config import get_config
from causal_gen_tpu_torch.models.hvae import HVAE
from causal_gen_tpu_torch.utils import viz

from tests.torch_parity import (
    load_jax_params,
    patch_jax_noise,
    random_jax_params,
    small_morpho_cfg,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("name,ctx", [("ukbb192", 3), ("ukbb192", 4), ("morphomnist", 12),
                                      ("cmnist", 20), ("vol3d32", 2)])
def test_cf_parents_are_jax_s(name, ctx):
    rng = np.random.default_rng(ctx)
    cfg, jcfg = get_config(name, context_dim=ctx), jget_config(name, context_dim=ctx)
    for _ in range(3):
        pa, other = rng.uniform(-1, 1, (2, ctx)).astype(np.float32)
        np.testing.assert_array_equal(viz.make_cf_parents(cfg, pa, other),
                                      jviz.make_cf_parents(jcfg, pa, other))


@pytest.mark.parametrize("shape", [(3, 1, 8, 8), (2, 1, 4, 6, 6)])
def test_postprocess_is_jax_s(shape):
    """NC(D)HW in [-1, 1] -> NHWC uint8, the middle depth slice of a volume."""
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    nhwc = x.transpose(0, *range(2, x.ndim), 1)
    np.testing.assert_array_equal(viz._postprocess(torch.from_numpy(x)), jviz._postprocess(nhwc))


def _diff_rows(n_cut: int, bs: int, n_effects: int):
    """Row indices of the grid's difference rows."""
    first = 1 + n_cut + 1 + len(viz.TEMPS) + 1
    per_sample = 2 * (1 + n_effects)
    rows = []
    for cut in range(n_cut):
        start = first + cut * (bs * per_sample + 1)
        rows += [start + i * per_sample + 2 * e + 1 for i in range(bs)
                 for e in range(1 + n_effects)]
    return rows


@pytest.mark.parametrize("n_latents_viz", [0, 2])
@pytest.mark.parametrize("cond_prior", [False, True])
def test_grid_matches_jax(monkeypatch, tmp_path, cond_prior, n_latents_viz):
    over = dict(cond_prior=cond_prior, cond_drop_from=2 if cond_prior else None)
    jcfg, tcfg = small_morpho_cfg(True, **over), small_morpho_cfg(False, **over)
    jvae = JHVAE(cfg=jcfg)
    params = random_jax_params(jvae, jcfg, seed=3)
    tvae = HVAE(tcfg, device="cpu")
    load_jax_params(tvae, params)
    rng = np.random.default_rng(1)
    bs = 2
    batch = {"x": rng.integers(0, 256, (bs, 16, 16, 1)).astype(np.uint8),
             "pa": rng.uniform(-1, 1, (bs, 12)).astype(np.float32)}
    rec = patch_jax_noise(monkeypatch, seed=7)
    with jax.disable_jit():
        ref = jviz.write_images(jcfg, jvae, params, batch, "", n_latents_viz=n_latents_viz)
    # chip_smoke.py's card check feeds write_images draws in this order
    import chip_smoke

    assert [tuple(d.shape) for d in rec.torch_noise()] == [
        d.shape for d in chip_smoke.viz_noise(tcfg, bs, rng, n_latents_viz)]
    path = str(tmp_path / "viz.png")
    got = viz.write_images(tcfg, tvae.eval(), batch, path, noise=iter(rec.torch_noise()),
                           n_latents_viz=n_latents_viz)
    assert got.shape == ref.shape and got.dtype == np.uint8
    n_cut = n_latents_viz + 1
    diff = (got.astype(np.int16) - ref.astype(np.int16)).reshape(-1, 16, got.shape[1], 1)
    rows = _diff_rows(n_cut, bs, 2 if cond_prior else 0)
    assert got.shape[0] == 16 * (rows[-1] + 2)  # the last difference row, then a blank
    image_rows = np.setdiff1d(np.arange(diff.shape[0]), rows)
    assert np.abs(diff[image_rows]).max() <= 1
    assert np.minimum(np.abs(diff[rows]) % 256, 256 - np.abs(diff[rows]) % 256).max() <= 1
    assert (got != ref).mean() < 0.01
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(path)), got[..., 0])
