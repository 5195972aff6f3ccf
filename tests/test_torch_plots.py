"""The port's PGM plots and NaN guard against the JAX package's.

``check_nan`` counts (and reports) as JAX's does. The arrays each figure
shows are JAX's exactly: every ``imshow`` of the counterfactual panel (image,
colour map, row title) and the data frame of the joint plot, recorded from
both packages' figures on the same inputs. Without matplotlib (or seaborn)
both return None.
"""

import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.axes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import seaborn  # noqa: E402

from causal_gen_tpu.utils import plots as jplots  # noqa: E402
from causal_gen_tpu_torch.utils import plots  # noqa: E402


def test_check_nan_counts_as_jax(capsys):
    tree = {"a": np.array([1.0, np.nan, np.nan]), "b": None, "c": np.zeros((2, 2)),
            "d": np.full((3, 1), np.nan)}
    assert plots.check_nan(tree) == jplots.check_nan(tree) == 5
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] and len(out) == 4


def _record(monkeypatch):
    shown = []
    original = matplotlib.axes.Axes.imshow

    def imshow(self, img, cmap=None, **kw):
        shown.append((np.array(img), cmap))
        return original(self, img, cmap=cmap, **kw)

    monkeypatch.setattr(matplotlib.axes.Axes, "imshow", imshow)
    return shown


@pytest.mark.parametrize("n,channels,var", [(3, 1, True), (1, 1, False), (2, 3, False)])
def test_cf_panel_shows_jax_s_arrays(monkeypatch, tmp_path, n, channels, var):
    rng = np.random.default_rng(n)
    x, cf_x, v = rng.uniform(-1, 1, (3, 10, 8, 8, channels)).astype(np.float32)
    v = np.abs(v) if var else None
    shown = _record(monkeypatch)
    fig = jplots.plot_cf(x, cf_x, v, num_images=n)
    ref = list(shown)
    ref_titles = [ax.get_title(loc="left") for ax in fig.axes]
    shown.clear()
    path = tmp_path / "panel.png"
    fig = plots.plot_cf(x, cf_x, v, num_images=n, save_path=str(path))
    assert path.exists()
    assert [ax.get_title(loc="left") for ax in fig.axes] == ref_titles
    assert len(shown) == len(ref) == n * (4 if var else 3)
    for (a, ca), (b, cb) in zip(shown, ref):
        assert ca == cb
        np.testing.assert_array_equal(a, b)
    rows = plots.cf_panel_rows(x, cf_x, v, num_images=n)
    assert [cmap for _, cmap, _ in rows] == [c for _, c in ref[::n]]


def test_joint_plot_shows_jax_s_frame(monkeypatch, tmp_path):
    frames = []
    original = seaborn.jointplot

    def jointplot(data=None, **kw):
        frames.append(data.copy())
        return original(data=data, **kw)

    monkeypatch.setattr(seaborn, "jointplot", jointplot)
    rng = np.random.default_rng(0)
    t, i = rng.uniform(0, 5, (2, 40, 1))
    assert jplots.plot_joint(t, i, "data") is not None
    assert plots.plot_joint(t, i, "data", save_path=str(tmp_path / "joint.png")) is not None
    assert (tmp_path / "joint.png").exists()
    assert list(frames[0].columns) == list(frames[1].columns) == ["thickness", "intensity"]
    np.testing.assert_array_equal(frames[0].to_numpy(), frames[1].to_numpy())
    cols = plots.joint_columns(t, i)
    np.testing.assert_array_equal(np.stack([cols["thickness"], cols["intensity"]], 1),
                                  frames[0].to_numpy())


@pytest.mark.parametrize("hidden", ["matplotlib", "seaborn"])
def test_figures_are_none_without_their_packages(monkeypatch, hidden):
    monkeypatch.setitem(sys.modules, hidden, None)
    if hidden == "matplotlib":
        for pkg in list(sys.modules):
            if pkg.startswith("matplotlib."):
                monkeypatch.setitem(sys.modules, pkg, None)
    x = np.zeros((2, 4, 4, 1), np.float32)
    for mod in (jplots, plots):
        assert mod.plot_joint(x[:, 0, 0], x[:, 0, 0], "t") is None
        if hidden == "matplotlib":
            assert mod.plot_cf(x, x) is None
