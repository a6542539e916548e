"""Leakage-safe temporal train/val/test masks (copy of
elliptic_gnn_tpu/graph/masks.py).

Semantics match the reference's make_temporal_masks
(reference src/data/dataset_elliptic.py:268-290):
  train = labeled & t <= t_train_end       (optionally a rolling window of the
                                            last `train_window_k` timesteps)
  val   = labeled & t_train_end < t <= t_val_end
  test  = labeled & t > t_val_end
Unlabeled nodes (y == -1) appear in no split but always participate in
message passing.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .data import GraphData


def make_temporal_masks(
    data: GraphData,
    t_train_end: int,
    t_val_end: int,
    train_window_k: Optional[int] = None,
) -> GraphData:
    y = data.y
    t = data.timestep
    labeled = y >= 0

    train_mask = (t <= t_train_end) & labeled
    val_mask = (t > t_train_end) & (t <= t_val_end) & labeled
    test_mask = (t > t_val_end) & labeled

    if train_window_k is not None:
        t_lo = max(1, int(t_train_end) - int(train_window_k) + 1)
        train_mask = (t >= t_lo) & (t <= t_train_end) & labeled

    return data.replace(
        train_mask=train_mask.astype(np.bool_),
        val_mask=val_mask.astype(np.bool_),
        test_mask=test_mask.astype(np.bool_),
    )
