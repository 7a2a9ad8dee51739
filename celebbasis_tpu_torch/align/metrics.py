"""Landmark and face-verification metrics.

Counterpart of ``celebbasis_tpu/align/metrics.py`` (numpy, a copy of its
own): NME, failure rate and AUC of the cumulative error curve for landmark
evaluation (the reference's PIPNet ``lib/functions.py``), and k-fold
verification accuracy with a threshold chosen per fold (the reference's
cosface ``lfw_eval.py``).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np


def compute_nme(lms_pred: np.ndarray, lms_gt: np.ndarray,
                norm: float) -> float:
    """Mean landmark distance normalized by `norm` (e.g. inter-ocular)."""
    p = lms_pred.reshape(-1, 2)
    g = lms_gt.reshape(-1, 2)
    return float(np.mean(np.linalg.norm(p - g, axis=1)) / norm)


def compute_fr_and_auc(nmes: Sequence[float], thres: float = 0.1,
                       step: float = 0.0001) -> Tuple[float, float]:
    """Failure rate at `thres` and the AUC of the cumulative error curve
    (trapezoidal integral)."""
    nmes = np.asarray(nmes)
    xs = np.arange(0, thres + step, step)
    ys = np.array([np.count_nonzero(nmes <= x) for x in xs]) / len(nmes)
    fr = 1.0 - ys[-1]
    auc = float(np.trapezoid(ys, xs) / thres)
    return float(fr), auc


def verification_accuracy(scores: np.ndarray, labels: np.ndarray,
                          n_folds: int = 10) -> Tuple[float, float]:
    """k-fold verification: pick the best threshold on k-1 folds, test on the
    held-out fold (lfw_eval's procedure). Returns (mean_acc, std)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    n = len(scores)
    idx = np.arange(n)
    folds = np.array_split(idx, n_folds)
    cands = np.unique(scores)
    accs = []
    for f in folds:
        test_mask = np.zeros(n, bool)
        test_mask[f] = True
        tr_s, tr_l = scores[~test_mask], labels[~test_mask]
        accs_tr = [( (tr_s >= t) == tr_l ).mean() for t in cands]
        best_t = cands[int(np.argmax(accs_tr))]
        accs.append(((scores[test_mask] >= best_t)
                     == labels[test_mask]).mean())
    return float(np.mean(accs)), float(np.std(accs))


def pairs_verification(embed_fn: Callable[[np.ndarray], np.ndarray],
                       pairs_a: np.ndarray, pairs_b: np.ndarray,
                       labels: np.ndarray, n_folds: int = 10
                       ) -> Tuple[float, float]:
    """Embed image pairs, cosine-score them, run k-fold verification."""
    fa = embed_fn(pairs_a)
    fb = embed_fn(pairs_b)
    fa = fa / (np.linalg.norm(fa, axis=1, keepdims=True) + 1e-8)
    fb = fb / (np.linalg.norm(fb, axis=1, keepdims=True) + 1e-8)
    return verification_accuracy((fa * fb).sum(1), labels, n_folds)
