"""Temperature scaling (port of elliptic_gnn_tpu/train/calibrate.py).

Fits one temperature T minimizing validation NLL of softmax(logits / T) by
the same guarded Newton iteration on log T (50 steps, step clipped to
[-1, 1]), with the gradient and curvature from autograd. Runs on the CPU:
the inputs are the validation logits already on the host.
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

