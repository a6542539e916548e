"""Evaluation metrics: pure-numpy, semantics-compatible with sklearn.

Copy of the numpy half of elliptic_gnn_tpu/utils/metrics.py (the port
imports nothing of the JAX package). Mirrors the reference metric surface
— PR-AUC (average precision), ROC-AUC, F1@threshold, max-F1 / precision-target
threshold pickers, Precision@K, Recall@Precision, ECE — but implemented
without the sklearn dependency so the training hot loop has no heavyweight
host-side imports. Unit tests assert exact agreement with sklearn on random
and adversarial (tied-score) inputs.

All functions take numpy arrays: ``y_true`` in {0,1} and continuous
``y_score``, except pr_auc_illicit_device, which takes tensors and runs on
their device (inside a captured CUDA graph too).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Cumulative TP/FP counts at each distinct descending threshold.

    Matches sklearn.metrics._ranking._binary_clf_curve for binary labels.
    Returns (fps, tps, thresholds), thresholds descending.
    """
    y_true = np.asarray(y_true).astype(np.int64)
    y_score = np.asarray(y_score).astype(np.float64)
    desc = np.argsort(-y_score, kind="stable")
    y_score = y_score[desc]
    y_true = y_true[desc]

    # indices of the last occurrence of each distinct score value
    distinct_idx = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct_idx, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs].astype(np.float64)
    fps = (1 + threshold_idxs - tps).astype(np.float64)
    thresholds = y_score[threshold_idxs]
    return fps, tps, thresholds


def precision_recall_curve(
    y_true: np.ndarray, y_score: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sklearn-compatible PR curve: precision/recall per ascending threshold,
    with the final (precision=1, recall=0) point appended."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    if tps[-1] == 0:
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    sl = slice(None, None, -1)
    return (
        np.hstack((precision[sl], 1)),
        np.hstack((recall[sl], 0)),
        thresholds[sl],
    )


def pr_auc_illicit_device(y_true: torch.Tensor, y_score: torch.Tensor) -> torch.Tensor:
    """Average precision as a 0-d f32 tensor on y_score's device, the same
    semantics as pr_auc_illicit (tie groups at distinct thresholds,
    step-wise AP): each positive contributes (1 / total positives) times the
    precision at the END of its tie group. Only ops of static shape and no
    host sync (stable sort, cumsum, a reversed cummin for each group's end,
    where), so the K-epoch loop runs it inside its captured epoch."""
    y = y_true.to(torch.int32)
    n = y_score.shape[0]
    if n == 0:
        return y_score.new_zeros((), dtype=torch.float32)
    order = torch.argsort(-y_score, stable=True)
    ys = y[order]
    ss = y_score[order]
    tps = torch.cumsum(ys, dim=0)
    total = tps[-1]
    idx = torch.arange(n, device=y_score.device)
    prec = tps.to(torch.float32) / (idx + 1).to(torch.float32)
    is_end = torch.cat([ss[:-1] != ss[1:], torch.ones(1, dtype=torch.bool,
                                                      device=y_score.device)])
    ends = torch.where(is_end, idx, torch.full_like(idx, n - 1))
    end_idx = torch.cummin(ends.flip(0), dim=0).values.flip(0)
    ap = torch.where(ys > 0, prec[end_idx], 0.0).sum() / torch.clamp(total, min=1)
    return torch.where(total > 0, ap, 0.0).to(torch.float32)


def pr_auc_illicit(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision for the illicit (positive=1) class.

    Step-wise AP = sum_n (R_n - R_{n-1}) P_n, identical to
    sklearn.average_precision_score (reference metrics.py:11-13).
    """
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def roc_auc_illicit(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC-AUC via the tie-aware Mann-Whitney U statistic.

    Equals sklearn.roc_auc_score (trapezoidal over the ROC curve) exactly,
    including tied scores (average ranks).
    """
    y_true = np.asarray(y_true).astype(np.int64)
    y_score = np.asarray(y_score).astype(np.float64)
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc is undefined with only one class present")
    order = np.argsort(y_score, kind="stable")
    ranks = np.empty(y_score.size, dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks over tied groups (1-based ranks)
    i = 0
    n = y_score.size
    idx = np.arange(1, n + 1, dtype=np.float64)
    # group boundaries of equal scores
    boundaries = np.r_[0, np.where(np.diff(sorted_scores))[0] + 1, n]
    for b0, b1 in zip(boundaries[:-1], boundaries[1:]):
        ranks[order[b0:b1]] = idx[b0:b1].mean()
        i = b1
    sum_pos_ranks = ranks[y_true == 1].sum()
    u = sum_pos_ranks - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def f1_at_threshold(y_true: np.ndarray, y_score: np.ndarray, thr: float) -> float:
    """F1 of predictions `score >= thr` (reference metrics.py:18-20)."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_pred = (np.asarray(y_score) >= thr).astype(np.int64)
    tp = float(np.sum((y_pred == 1) & (y_true == 1)))
    fp = float(np.sum((y_pred == 1) & (y_true == 0)))
    fn = float(np.sum((y_pred == 0) & (y_true == 1)))
    denom = 2 * tp + fp + fn
    if denom == 0:
        return 0.0
    return float(2 * tp / denom)


def pick_threshold_max_f1(
    y_true: np.ndarray, y_score: np.ndarray
) -> Tuple[float, float]:
    """Threshold maximizing F1 along the PR curve (reference metrics.py:22-27).

    Appends 1.0 to the thresholds to align lengths with precision/recall,
    exactly as the reference does.
    """
    precision, recall, thresholds = precision_recall_curve(y_true, y_score)
    thresholds = np.append(thresholds, 1.0)
    f1s = 2 * precision * recall / (precision + recall + 1e-12)
    i = int(np.nanargmax(f1s))
    return float(thresholds[i]), float(f1s[i])


def pick_threshold_for_precision(
    y_true: np.ndarray, y_score: np.ndarray, target_p: float
) -> float:
    """First threshold whose precision meets target; falls back to max-F1
    (reference metrics.py:29-36)."""
    precision, recall, thresholds = precision_recall_curve(y_true, y_score)
    thr_candidates = np.append(thresholds, 1.0)
    mask = precision >= target_p
    if not np.any(mask):
        return pick_threshold_max_f1(y_true, y_score)[0]
    idx = int(np.argmax(mask))
    return float(thr_candidates[idx])


def precision_at_k(y_true: np.ndarray, y_score: np.ndarray, k: int) -> float:
    """Fraction of positives among the top-k scored items (metrics.py:38-40)."""
    idx = np.argsort(-np.asarray(y_score))[:k]
    return float(np.mean(np.asarray(y_true)[idx]))


def recall_at_precision(
    y_true: np.ndarray, y_score: np.ndarray, target_p: float
) -> float:
    """Max recall attainable at >= target precision (metrics.py:42-47)."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    mask = precision >= target_p
    if not np.any(mask):
        return 0.0
    return float(np.max(recall[mask]))


def expected_calibration_error(
    y_true: np.ndarray, y_prob: np.ndarray, bins: int = 15
) -> float:
    """ECE over equal-width probability bins; last bin closed on the right
    (reference metrics.py:49-66)."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_prob = np.asarray(y_prob).astype(np.float64)
    bin_edges = np.linspace(0.0, 1.0, bins + 1)
    ece = 0.0
    for i in range(bins):
        lo, hi = bin_edges[i], bin_edges[i + 1]
        if i < bins - 1:
            mask = (y_prob >= lo) & (y_prob < hi)
        else:
            mask = (y_prob >= lo) & (y_prob <= hi)
        if not np.any(mask):
            continue
        conf = y_prob[mask].mean()
        acc = y_true[mask].mean()
        ece += mask.mean() * abs(acc - conf)
    return float(ece)


def per_timestep_pr_auc(
    y_true: np.ndarray, y_score: np.ndarray, timesteps: np.ndarray
) -> Tuple[list, list]:
    """PR-AUC per distinct timestep in chronological order.

    Returns (sorted unique timesteps, PR-AUC list; NaN where a timestep has
    no samples of the positive class). Mirrors the per-timestep loop in the
    reference trainer (train_gnn.py:497-519).
    """
    timesteps = np.asarray(timesteps)
    uniq = sorted(set(int(t) for t in timesteps.tolist()))
    out = []
    for t in uniq:
        idx = timesteps == t
        if idx.sum() == 0:
            out.append(float("nan"))
        else:
            out.append(pr_auc_illicit(np.asarray(y_true)[idx], np.asarray(y_score)[idx]))
    return uniq, out


def tail_means(values: list, ks=(1, 3, 5)) -> dict:
    """Mean over the last-k entries for each k with len >= k, keyed
    `pr_auc_last{k}` (train_gnn.py:510-519)."""
    out = {}
    for k in ks:
        if len(values) >= k:
            out[f"pr_auc_last{k}"] = float(sum(values[-k:]) / k)
    return out
