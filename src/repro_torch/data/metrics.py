"""Evaluation metrics; numpy copy of ``repro.data.metrics``. ROC-AUC via the
Mann-Whitney U rank statistic, exactly equivalent to the trapezoidal
ROC integral used by the paper."""
from __future__ import annotations

import numpy as np


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """AUC = P(score_anomalous > score_normal), ties counted half.

    ``labels`` is 1 for anomalous, 0 for normal; ``scores`` are anomaly
    scores (higher = more anomalous).
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    if not np.isfinite(scores).all():
        raise ValueError("roc_auc got non-finite scores")
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        raise ValueError("roc_auc needs both classes present")
    order = np.argsort(np.concatenate([neg, pos]), kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ranks for ties
    all_scores = np.concatenate([neg, pos])
    sorted_scores = all_scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            avg = 0.5 * (i + 1 + j + 1)
            ranks[order[i : j + 1]] = avg
        i = j + 1
    r_pos = ranks[len(neg):].sum()
    n_pos, n_neg = len(pos), len(neg)
    u = r_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))
