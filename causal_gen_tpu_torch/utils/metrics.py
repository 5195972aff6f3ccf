"""Evaluation metrics of the PGM predictors (numpy only).

The port's own copy of ``causal_gen_tpu/utils/metrics.py`` (reference
train_pgm.py:174-249): ROC-AUC by the rank statistic (Mann-Whitney U, ties
at their average rank; sklearn's ``roc_auc_score`` for binary labels),
one-vs-rest macro ROC-AUC, accuracies and the mean absolute error.
"""

from __future__ import annotations

import numpy as np


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
