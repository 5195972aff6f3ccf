"""PGM plots and the NaN guard of the port.

Counterpart of ``causal_gen_tpu/utils/plots.py`` (reference
src/pgm/utils_pgm.py: check_nan 31-38, plot_joint 58-90, plot_cf 93-286).
The figures are optional: matplotlib (and seaborn and pandas for the joint
plot) are imported when a figure is drawn, and each function returns None
where they are missing. The arrays each figure shows come from
``joint_columns`` and ``cf_panel_rows``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def check_nan(tree: Dict[str, Any]) -> int:
    """Count NaNs across a dict of arrays (reference utils_pgm.py:31-38),
    printing the count of each entry that has any."""
    nans = 0
    for k, v in tree.items():
        if v is None:
            continue
        n = int(np.isnan(np.asarray(v)).sum())
        if n:
            print(f"Found {n} nan(s) in {k}, skipping step.")
        nans += n
    return nans


def joint_columns(thickness: np.ndarray, intensity: np.ndarray) -> Dict[str, np.ndarray]:
    """The two columns of the joint plot, flattened."""
    return {"thickness": np.ravel(thickness), "intensity": np.ravel(intensity)}


def plot_joint(thickness: np.ndarray, intensity: np.ndarray, title: str,
               save_path: Optional[str] = None):
    """Joint scatter of two morphometrics (reference utils_pgm.py:58-90)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import pandas as pd
        import seaborn as sns
    except Exception:
        return None
    plt.close("all")
    g = sns.jointplot(data=pd.DataFrame(joint_columns(thickness, intensity)),
                      x="thickness", y="intensity")
    plt.suptitle(title)
    plt.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        plt.savefig(save_path)
    return g


def cf_panel_rows(x: np.ndarray, cf_x: np.ndarray, var_cf_x: Optional[np.ndarray] = None,
                  num_images: int = 8) -> List[Tuple[str, str, np.ndarray]]:
    """(title, colour map, images) of each row of the counterfactual panel:
    the observations, the counterfactuals, the direct effect cf - obs and,
    given ``var_cf_x``, the uncertainty; the first ``num_images`` each, a
    trailing channel of 1 dropped."""
    x = np.asarray(x)[:num_images]
    cf_x = np.asarray(cf_x)[:num_images]
    rows = [("observation", "Greys_r", x), ("counterfactual", "Greys_r", cf_x),
            ("direct effect", "RdBu_r", cf_x - x)]
    if var_cf_x is not None:
        rows.append(("uncertainty", "jet", np.asarray(var_cf_x)[:num_images]))

    def squeeze(img):
        return img[..., 0] if img.ndim == 3 and img.shape[-1] == 1 else img

    return [(title, cmap, np.stack([squeeze(im) for im in imgs]))
            for title, cmap, imgs in rows]


def plot_cf(x: np.ndarray, cf_x: np.ndarray, var_cf_x: Optional[np.ndarray] = None,
            num_images: int = 8, save_path: Optional[str] = None):
    """Counterfactual panel, one row each of ``cf_panel_rows`` (reference
    utils_pgm.py:93-286, the JAX package's simplified layout). Images are
    N(D)HWC-last arrays, as the JAX figure takes them."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    plt.close("all")
    rows = cf_panel_rows(x, cf_x, var_cf_x, num_images)
    n = rows[0][2].shape[0]
    fig, axes = plt.subplots(len(rows), n, figsize=(n * 1.6, len(rows) * 1.8))
    if n == 1:
        axes = axes[:, None]
    for r, (title, cmap, imgs) in enumerate(rows):
        for j in range(n):
            axes[r, j].imshow(imgs[j], cmap=cmap)
            axes[r, j].axis("off")
        axes[r, 0].set_title(title, loc="left", fontsize=8)
    plt.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        plt.savefig(save_path, dpi=120)
    return fig
