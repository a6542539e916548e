"""Loss functions: class-weighted CE, focal loss, time-weighted variants
(port of elliptic_gnn_tpu/models/losses.py).

  - inverse-frequency class weights w_c = (P+N) / (2 * count_c)
  - focal: (1 - p_t)^gamma * CE (unweighted CE inside focal)
  - time reweighting: normalized train-time in [0,1], 'linear' or 'sqrt',
    clamped to >= 1e-3
  - optional L2 on the learned time-embedding table
The masked mean divides by the mask COUNT, not by the sum of class weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def class_weights(train_y: np.ndarray) -> np.ndarray:
    """Inverse-frequency weights [w_neg, w_pos]."""
    pos = int((train_y == 1).sum())
    neg = int((train_y == 0).sum())
    if pos == 0 or neg == 0:
        return np.array([1.0, 1.0], dtype=np.float32)
    tot = pos + neg
    return np.array([tot / (2.0 * neg), tot / (2.0 * pos)], dtype=np.float32)


def cross_entropy_per_sample(logits, targets, weights=None):
    """Per-sample CE over 2-class logits; optional per-class weights."""
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, targets[:, None].long())[:, 0]
    if weights is not None:
        ce = ce * weights[targets.long()]
    return ce


def make_loss_parts(cfg: dict, cw: np.ndarray, t_min: int, t_max: int,
                    device=None):
    """The loss factory split into composable parts:

      loss_vec_fn(logits, targets, t_idx) -> per-sample loss vector
      penalty_fn(model)                   -> scalar parameter penalty

    The class weights are put on `device` once, here: a call makes no
    host-to-device copy (none may happen inside a captured CUDA graph)."""
    use_focal = bool(cfg.get("focal_loss", False))
    gamma = float(cfg.get("focal_gamma", 2.0))
    scheme = str(cfg.get("time_loss_weighting", "none"))
    embed_l2 = float(cfg.get("time_embed_l2", 0.0))
    cw_t = torch.as_tensor(np.asarray(cw, np.float32), device=device)
    denom_t = max(float(t_max - t_min), 1.0)
    if scheme not in ("none", "linear", "sqrt"):
        raise ValueError(f"unknown time_loss_weighting={scheme}")

    def loss_vec_fn(logits, targets, t_idx=None):
        targets = targets.long()
        if use_focal:
            ce = cross_entropy_per_sample(logits, targets)
            p = torch.softmax(logits, dim=1)
            pt = p.gather(1, targets[:, None])[:, 0]
            loss_vec = ((1.0 - pt) ** gamma) * ce
        else:
            loss_vec = cross_entropy_per_sample(
                logits, targets, cw_t.to(logits.device))
        if scheme != "none" and t_idx is not None:
            wt = (t_idx.to(torch.float32) - float(t_min)) / denom_t
            if scheme == "sqrt":
                wt = torch.sqrt(torch.clamp(wt, min=0.0))
            wt = torch.clamp(wt, min=1e-3)
            loss_vec = loss_vec * wt
        return loss_vec

    def penalty_fn(model):
        time_emb = getattr(model, "time_emb", None)
        if embed_l2 > 0.0 and time_emb is not None:
            return embed_l2 * torch.mean(time_emb ** 2)
        return None

    return loss_vec_fn, penalty_fn


def make_loss_fn(cfg: dict, cw: np.ndarray, t_min: int, t_max: int, device=None):
    """Returns loss(model, logits, targets, t_idx, sample_mask) -> scalar:
    the mean over the mask count of the per-sample losses, plus the
    penalty."""
    loss_vec_fn, penalty_fn = make_loss_parts(cfg, cw, t_min, t_max, device)

    def loss_fn(model, logits, targets, t_idx=None, sample_mask=None):
        loss_vec = loss_vec_fn(logits, targets, t_idx)
        if sample_mask is not None:
            m = sample_mask.to(loss_vec.dtype)
            loss = (loss_vec * m).sum() / torch.clamp(m.sum(), min=1.0)
        else:
            loss = loss_vec.mean()
        penalty = penalty_fn(model)
        return loss if penalty is None else loss + penalty

    return loss_fn
