"""The soft-morphometry surrogates and the measuring tools against the JAX
package: ``causal_gen_tpu_torch/ops/soft_morph.py`` against
``causal_gen_tpu/ops/soft_morph.py`` on seeded strokes and bars (values
within 1e-5 rel, gradients with respect to the image within 1e-4 abs + rel),
the x4 upsample's edge rows, the +inf padding of the 3-tap minimum and its
gradient at ties, the detached threshold, the calibration; and
``eval/morphometrics.py`` equal to JAX's, the same numpy code."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from causal_gen_tpu.eval import morphometrics as jmorph
from causal_gen_tpu.ops import soft_morph as jsm
from causal_gen_tpu_torch.eval import morphometrics as tmorph
from causal_gen_tpu_torch.ops import soft_morph as tsm

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=0.0)
GRAD = dict(rtol=1e-4, atol=1e-4)


def bar(width: int, value: float = 1.0, res: int = 32) -> np.ndarray:
    img = np.zeros((res, res), np.float32)
    img[res // 2 - width // 2: res // 2 - width // 2 + width, 4: res - 4] = value
    return img


def strokes(n: int, res: int, seed: int) -> np.ndarray:
    """Seeded digit-like images in [0, 1]: a blurred random polyline of
    random width on a faint noisy background."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, res, res), np.float32)
    yy, xx = np.mgrid[:res, :res]
    for i in range(n):
        pts = rng.uniform(res * 0.2, res * 0.8, (4, 2))
        w = rng.uniform(0.8, 3.0)
        for a, b in zip(pts[:-1], pts[1:]):
            for t in np.linspace(0, 1, 24):
                c = a + t * (b - a)
                out[i] = np.maximum(out[i], np.exp(-((yy - c[0]) ** 2 + (xx - c[1]) ** 2)
                                                   / (2 * w * w)))
        out[i] += rng.uniform(0, 0.05, (res, res))
    return np.clip(out, 0, 1).astype(np.float32)


def images():
    return np.concatenate([strokes(6, 28, seed=1),
                           np.stack([bar(w, res=28) for w in (1, 2, 3, 5)])])


def _grad_torch(fn, x):
    t = torch.tensor(x, requires_grad=True)
    fn(t).sum().backward()
    return t.grad.numpy()


def test_upsample_matches_jax_resize_at_the_edges():
    """F.interpolate(bilinear, align_corners=False) against
    jax.image.resize(linear) on an upsample by 4: every row, the edge rows
    included (a tap outside the image is dropped and the weights
    renormalised in JAX; PyTorch clamps the source coordinate)."""
    x = np.random.default_rng(0).uniform(0, 1, (3, 9, 7)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, 36, 28), "linear"))
    got = F.interpolate(torch.from_numpy(x)[:, None], size=(36, 28), mode="bilinear",
                        align_corners=False)[:, 0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, :, -2:], ref[:, :, -2:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["values", "ties"])
def test_soft_erode_and_its_gradient_match_jax(kind):
    """The +inf padded 3-tap minimum and its VJP: on distinct values, and on
    a saturated map of 0s and 1s where every window ties (both split the
    gradient evenly between tied inputs)."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, 12, 10)).astype(np.float32)
    if kind == "ties":
        x = (x > 0.5).astype(np.float32)
    w = rng.uniform(-1, 1, x.shape).astype(np.float32)
    np.testing.assert_array_equal(tsm.soft_erode(torch.from_numpy(x)).numpy(),
                                  np.asarray(jsm.soft_erode(jnp.asarray(x))))
    ref = np.asarray(jax.grad(lambda v: (jsm.soft_erode(v) * w).sum())(jnp.asarray(x)))
    got = _grad_torch(lambda v: tsm.soft_erode(v) * torch.from_numpy(w), x)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    if kind == "ties":
        assert np.any((ref != 0) & (np.abs(ref) < np.abs(w)))  # a split gradient was compared


@pytest.mark.parametrize("temp", [0.02, 0.1])
def test_soft_thickness_and_intensity_match_jax(temp):
    """Values within 1e-5 rel of JAX's, plus the JAX run's own distance from
    the JAX package's float64 run of the same function (at temp 0.1 XLA's
    float32 result lies up to 1.6e-5 rel from it on the bars; the port's
    within 1e-6), and within 1e-6 rel of that float64 run; gradients within
    1e-4 abs + rel."""
    x = images()
    for t_fn, j_fn in ((lambda v: tsm.soft_thickness_raw(v, temp=temp),
                        lambda v: jsm.soft_thickness_raw(v, temp=temp)),
                       (lambda v: tsm.soft_thickness(v, calib=(1.2232, 0.5295), temp=temp),
                        lambda v: jsm.soft_thickness(v, calib=(1.2232, 0.5295), temp=temp)),
                       (lambda v: tsm.soft_intensity(v * 255.0),
                        lambda v: jsm.soft_intensity(v * 255.0))):
        ref = np.asarray(j_fn(jnp.asarray(x)), np.float64)
        with jax.enable_x64(True):
            ref64 = np.asarray(j_fn(jnp.asarray(x, jnp.float64)))
        got = t_fn(torch.from_numpy(x)).numpy()
        assert np.all(np.abs(got - ref) <= VAL["rtol"] * np.abs(ref) + np.abs(ref - ref64)), (
            got, ref, ref64)
        np.testing.assert_allclose(got, ref64, rtol=1e-6)
        g_ref = np.asarray(jax.grad(lambda v: j_fn(v).sum())(jnp.asarray(x)))
        g_got = _grad_torch(t_fn, x)
        assert np.abs(g_ref).max() > 0
        np.testing.assert_allclose(g_got, g_ref, **GRAD)


def test_the_threshold_takes_no_gradient():
    """soft_binarize's per-image min and max are detached, as JAX stops them:
    the gradient is the sigmoid's alone."""
    x = images()[:3]
    ref = np.asarray(jax.grad(lambda v: jsm.soft_binarize(v).sum())(jnp.asarray(x)))
    got = _grad_torch(tsm.soft_binarize, x)
    np.testing.assert_allclose(got, ref, **GRAD)
    lo = x.min(axis=(1, 2), keepdims=True)
    thr = lo + (x.max(axis=(1, 2), keepdims=True) - lo) * 0.5
    s = 1.0 / (1.0 + np.exp(-(x - thr) / 0.02))
    np.testing.assert_allclose(got, s * (1 - s) / 0.02, **GRAD)  # the sigmoid's derivative


def test_calibration_matches_jax():
    rng = np.random.default_rng(0)
    x = np.stack([bar(int(w)) for w in rng.integers(1, 6, 16)])
    (a, b), fit = tsm.calibrate_soft_thickness(x)
    (ja, jb), jfit = jsm.calibrate_soft_thickness(x)
    np.testing.assert_allclose([a, b, fit], [ja, jb, jfit], rtol=1e-4)
    assert fit < 0.3
    raw = rng.uniform(0, 3, 20)
    meas = 1.5 * raw + 0.2 + rng.normal(0, 0.01, 20)
    assert tsm.fit_calibration(raw, meas) == jsm.fit_calibration(raw, meas)


def test_morphometrics_equal_jax():
    x = np.concatenate([images() * 255.0, np.zeros((1, 28, 28), np.float32)])
    np.testing.assert_array_equal(tmorph.get_intensity(x), jmorph.get_intensity(x))
    np.testing.assert_array_equal(tmorph.measure_thickness(x), jmorph.measure_thickness(x))
    skel = tmorph._zhang_suen_thin(x[0] > 127)
    np.testing.assert_array_equal(skel, jmorph._zhang_suen_thin(x[0] > 127))
