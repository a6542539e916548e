"""The reference's view of one configuration's graph: the trainer's
preprocessing worked out again from the generated arrays, in the graph's
own node ids, on one device."""
from __future__ import annotations

import numpy as np
import torch

from . import common


class Graph:
    """x, y, timestep, edges (src, dst), the train and val masks and the
    class weights of `cfg` on `arrays` (the generator's x, y, timestep,
    edge_index), and `rank`: the row of each node in the order the program
    trains in (breadth-first for the BSDA tables, degree buckets for
    `aggregation: ell`)."""

    def __init__(self, cfg: dict, arrays: dict, t_train_end: int, t_val_end: int,
                 device, half_batch: bool = False):
        x = np.asarray(arrays["x"], np.float32)
        y = np.asarray(arrays["y"], np.int64)
        t = np.asarray(arrays["timestep"], np.int64)
        ei = np.asarray(arrays["edge_index"], np.int64)
        n = x.shape[0]
        train, val = common.temporal_masks(y, t, t_train_end, t_val_end, None)
        if cfg.get("train_window_k") is not None:
            # the window counts back from the last timestep that has a
            # labelled train node
            train, val = common.temporal_masks(y, t, int(t[train].max()), int(t[val].max()),
                                               cfg["train_window_k"])
        if cfg.get("use_time_scalar", False) and int(cfg.get("time_embed_dim", 0) or 0) == 0:
            x = np.concatenate([x, (t.astype(np.float32) / float(t.max()))[:, None]], axis=1)
        if cfg.get("symmetrize_edges", False):
            ei = np.concatenate([ei, ei[::-1]], axis=1)
        if str(cfg.get("aggregation", "auto")) == "ell":
            self.rank = common.degree_bucket_rank(ei[1], n)
        else:
            self.rank = common.bfs_rank(ei, n, t)
        cw = common.class_weights(y[train])
        if half_batch:  # a fault: every other train row left out of the loss
            idx = np.flatnonzero(train)
            train = train.copy()
            train[idx[1::2]] = False
        self.n = n
        self.device = device
        self.x = torch.from_numpy(x).to(device)
        self.t = torch.from_numpy(t).to(device)
        self.y = torch.from_numpy(np.maximum(y, 0)).to(device)
        self.src = torch.from_numpy(ei[0]).to(device)
        self.dst = torch.from_numpy(ei[1]).to(device)
        self.train_mask = torch.from_numpy(train).to(device)
        self.val_idx = torch.from_numpy(np.flatnonzero(val)).to(device)
        self.y_val = (y[val] == 1).astype(np.int64)
        self.cw = torch.from_numpy(cw).to(device)
        self.rank_t = torch.from_numpy(self.rank).to(device)
