"""Probability calibration (port of elliptic_gnn_tpu/train/calibrate.py):
temperature scaling for the GNN runs, isotonic and Platt for the baselines.

fit_temperature finds one temperature T minimizing validation NLL of
softmax(logits / T) by the same guarded Newton iteration on log T (50
steps, step clipped to [-1, 1]), with the gradient and curvature from
autograd. Runs on the CPU: the inputs are the validation logits already on
the host. The isotonic and Platt calibrators (train_baselines.py) are
sklearn's, imported where they are fit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _nll(log_t, logits, labels):
    logp = F.log_softmax(logits / torch.exp(log_t), dim=-1)
    return -logp.gather(1, labels[:, None])[:, 0].mean()


def fit_temperature(logits_val: np.ndarray, labels_val: np.ndarray) -> float:
    """Return T minimizing validation NLL of softmax(logits / T)."""
    logits = torch.as_tensor(np.asarray(logits_val, np.float32))
    labels = torch.as_tensor(np.asarray(labels_val, np.int64))
    lt = torch.zeros((), dtype=torch.float32)
    for _ in range(50):
        x = lt.clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(_nll(x, logits, labels), x, create_graph=True)
        (hess,) = torch.autograd.grad(grad, x)
        grad = grad.detach()
        if torch.abs(hess) > 1e-12:
            delta = torch.clamp(grad / hess, -1.0, 1.0)
        else:
            delta = torch.zeros(())
        lt = lt - delta
    return float(np.exp(lt.numpy()))


def calibrated_probs(logits: np.ndarray, temperature: float = 1.0) -> np.ndarray:
    """P(illicit) = softmax(logits / T)[:, 1] of [N, 2] logits."""
    z = logits / float(temperature)
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return (e / e.sum(axis=1, keepdims=True))[:, 1]


def apply_temperature(logits: np.ndarray, t: float) -> np.ndarray:
    return np.asarray(logits) / float(t)


def calibrate_isotonic(y_score_val, y_true_val):
    from sklearn.isotonic import IsotonicRegression

    ir = IsotonicRegression(out_of_bounds="clip")
    ir.fit(np.asarray(y_score_val), np.asarray(y_true_val))
    return ir


def calibrate_platt(y_score_val, y_true_val):
    from sklearn.linear_model import LogisticRegression

    lr = LogisticRegression(solver="lbfgs", max_iter=1000)
    lr.fit(np.asarray(y_score_val).reshape(-1, 1), np.asarray(y_true_val))
    return lr


def apply_sklearn_calibrator(cal, y_score: np.ndarray) -> np.ndarray:
    if hasattr(cal, "predict_proba"):
        return cal.predict_proba(np.asarray(y_score).reshape(-1, 1))[:, 1]
    return cal.transform(np.asarray(y_score))
