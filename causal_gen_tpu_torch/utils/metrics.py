"""Evaluation metrics of the PGM predictors (numpy only).

The port's own copy of ``causal_gen_tpu/utils/metrics.py`` (reference
train_pgm.py:174-249): ROC-AUC by the rank statistic (Mann-Whitney U, ties
at their average rank; sklearn's ``roc_auc_score`` for binary labels),
one-vs-rest macro ROC-AUC, accuracies and the mean absolute error; and
``attribute_metrics``, the per-dataset metrics of the predictors (PGM
training) and of the counterfactuals (CF training and evaluation).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from causal_gen_tpu_torch.utils.normalization import MORPHOMNIST_MIN_MAX, get_attr_max_min


def roc_auc_binary(targets: np.ndarray, scores: np.ndarray) -> float:
    """AUC of ``scores`` for 0/1 ``targets``; NaN when a class is absent."""
    t = np.asarray(targets).ravel()
    s = np.asarray(scores, np.float64).ravel()
    neg, pos = s[t == 0], s[t == 1]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    both = np.concatenate([neg, pos])
    order = np.argsort(both, kind="mergesort")
    _, inv, counts = np.unique(both[order], return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    ranks = np.empty(len(both), np.float64)
    ranks[order] = (cum - (counts - 1) / 2.0)[inv]  # average rank of each tie
    u = ranks[len(neg):].sum() - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


def roc_auc_ovr_macro(targets_onehot: np.ndarray, probs: np.ndarray) -> float:
    """One-vs-rest macro AUC over the classes present and absent somewhere
    (sklearn's multi_class="ovr")."""
    aucs = [roc_auc_binary(targets_onehot[:, k], probs[:, k])
            for k in range(targets_onehot.shape[-1])
            if 0 < targets_onehot[:, k].sum() < len(targets_onehot)]
    return float(np.mean(aucs)) if aucs else float("nan")


def accuracy_binary(targets: np.ndarray, probs: np.ndarray) -> float:
    return float((np.asarray(targets).ravel() == np.round(np.asarray(probs).ravel())).mean())


def accuracy_onehot(targets_onehot: np.ndarray, probs: np.ndarray) -> float:
    return float((np.asarray(targets_onehot).argmax(-1) == np.asarray(probs).argmax(-1)).mean())


def mae(targets: np.ndarray, preds: np.ndarray) -> float:
    return float(np.abs(np.asarray(targets) - np.asarray(preds)).mean())


def attribute_metrics(dataset: str, preds: Dict[str, np.ndarray],
                      targets: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The metrics of each variable in ``preds`` against ``targets`` (PGM
    space), in the attributes' own units (reference eval_epoch,
    train_pgm.py:174-249, and get_metrics, train_cf.py:63-108): ROC-AUC and
    accuracy of the binary variables, MAE of the continuous ones (UK Biobank
    volumes in ml / 1000, MIMIC age in years), accuracy (and macro ROC-AUC
    for race) of the categorical ones. ``dataset`` is a PGM's dataset or an
    image configuration's name (``ukbb192``, ``mimic192``, ...)."""
    stats: Dict[str, float] = {}
    for k in preds:
        P, T = np.asarray(preds[k]), np.asarray(targets[k])
        if "ukbb" in dataset:
            if k in ("mri_seq", "sex"):
                stats[k + "_rocauc"] = roc_auc_binary(T, P)
                stats[k + "_acc"] = accuracy_binary(T, P)
            else:
                _max, _min = get_attr_max_min(k)
                p = (P + 1) / 2 * (_max - _min) + _min
                t = (T + 1) / 2 * (_max - _min) + _min
                stats[k + "_mae"] = mae(t, p) / (1000.0 if "volume" in k else 1.0)
        elif "mimic" in dataset:
            if k in ("sex", "finding"):
                stats[k + "_rocauc"] = roc_auc_binary(T, P)
                stats[k + "_acc"] = accuracy_binary(T, P)
            elif k == "age":
                stats[k + "_mae"] = mae((T + 1) * 50, (P + 1) * 50)
            elif k == "race":
                stats[k + "_acc"] = accuracy_onehot(T, P)
                stats[k + "_rocauc"] = roc_auc_ovr_macro(T, P)
        elif "morphomnist" in dataset:
            if k == "digit":
                stats[k + "_acc"] = accuracy_onehot(T, P)
            else:
                lo, hi = MORPHOMNIST_MIN_MAX[k]
                stats[k + "_mae"] = mae((T + 1) / 2 * (hi - lo) + lo, (P + 1) / 2 * (hi - lo) + lo)
        else:
            stats[k + "_acc"] = accuracy_onehot(T, P) if T.ndim > 1 else accuracy_binary(T, P)
    return stats
