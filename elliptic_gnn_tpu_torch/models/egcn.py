"""EvolveGCN-O (arch egcn_o): a GCN whose weights evolve from snapshot to
snapshot through a matrix GRU (Pareja et al., "EvolveGCN: Evolving Graph
Convolutional Networks for Dynamic Graphs", AAAI 2020, arXiv:1902.10191;
github.com/IBM/EvolveGCN, egcn_o.py and models.py::Classifier).

    model = build_model("egcn_o", in_dim, cfg, generator=gen)
    logits = model(x, g, t_idx)

`layers` GRCU layers (d_in -> hidden_dim -> ... -> hidden_dim), then the
classifier Linear(hidden_dim, cls_feats) -> ReLU -> Linear(cls_feats, 2).
GRCU layer l at snapshot t = 1..max_timestep:

    Q_t = GRU(Q_{t-1})                  (kernels/egcn_evolve.py; Q_0 learned)
    H_t^{l+1} = act(A_t H_t^l Q_t)

A_t = D^-1/2 (A + I) D^-1/2 of the snapshot's directed edges (the port's
`gcn` graph kind), act LeakyReLU with slope 11/48: the official runner's
RReLU in its eval form (the mean of its slopes 1/8 and 1/3), since random
slopes in training are draws no reference can follow. No dropout. f32
throughout, whatever `amp` says.

Every edge joins two rows of one timestep and the trainer's BFS order keeps
each timestep's rows contiguous, blocks in order (`check_snapshots`), so A
is block-diagonal: one aggregation over the whole graph computes every
A_t (H_t Q_t) at once, and the product of the rows by their timestep's
weights is a product grouped by timestep over contiguous row ranges (ATen
calls on the slices, `grouped_rows_mm`). The rows' timesteps `t_idx`
(1-based, non-decreasing) give the ranges, read once to the host before a
capture and kept with the tensor's address.

On CUDA tensors the chain runs through the hand-written kernels (one
persistent launch a pass of the chain at the configuration's widths); on
CPU tensors the model takes `forward_plain` (ATen ops and autograd), the
kernels' yardstick. The full-batch trainer alone runs it: the ELL
encoding, `mini_batch` and meshes refuse it (`check_route`).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..kernels import spmm
from ..kernels.egcn_evolve import PARAMS, evolve, evolve_plain
from .modules import _glorot_, _linear

ARCH = "egcn_o"
SLOPE = 11.0 / 48.0  # RReLU(1/8, 1/3) in eval: the mean of its bounds


def _glorot(shape, fan_in: int, fan_out: int, generator) -> nn.Parameter:
    w = nn.Parameter(torch.empty(shape))
    _glorot_(w, fan_in, fan_out, generator)
    return w


class GRCU(nn.Module):
    """One GRCU layer's parameters: the initial weights q0 [d_in, d_out],
    the GRU's w_* and u_* [d_in, d_in] and b_* [d_in, d_out] for the
    update (u), reset (r) and candidate (h) gates."""

    def __init__(self, d_in: int, d_out: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.q0 = _glorot((d_in, d_out), d_in, d_out, generator)
        for gate in ("u", "r", "h"):
            setattr(self, f"w_{gate}", _glorot((d_in, d_in), d_in, d_in, generator))
            setattr(self, f"u_{gate}", _glorot((d_in, d_in), d_in, d_in, generator))
            setattr(self, f"b_{gate}", nn.Parameter(torch.zeros(d_in, d_out)))

    def params(self) -> dict:
        return {k: getattr(self, k) for k in PARAMS}


class _GroupedRows(torch.autograd.Function):
    """out[rows of t] = h[rows of t] @ qs[t], t over the snapshots, with
    ATen products on contiguous row slices; backward the slices' products
    again (dh) and dqs[t] = h[rows]^T dout[rows] (zero for a snapshot
    without rows)."""

    @staticmethod
    def forward(ctx, h, qs, bounds):
        out = h.new_empty((h.shape[0], qs.shape[2]))
        for t, (a, b) in enumerate(bounds):
            if b > a:
                torch.mm(h[a:b], qs[t], out=out[a:b])
        ctx.save_for_backward(h, qs)
        ctx.bounds = bounds
        return out

    @staticmethod
    def backward(ctx, g):
        h, qs = ctx.saved_tensors
        g = g.contiguous()
        dh = torch.empty_like(h) if ctx.needs_input_grad[0] else None
        dqs = torch.empty_like(qs) if ctx.needs_input_grad[1] else None
        for t, (a, b) in enumerate(ctx.bounds):
            if b == a:
                if dqs is not None:
                    dqs[t].zero_()
                continue
            if dh is not None:
                torch.mm(g[a:b], qs[t].t(), out=dh[a:b])
            if dqs is not None:
                torch.mm(h[a:b].t(), g[a:b], out=dqs[t])
        return dh, dqs, None


def grouped_rows_mm(h: torch.Tensor, qs: torch.Tensor, bounds) -> torch.Tensor:
    """Each snapshot's rows [a, b) of h times its weights qs[t]."""
    return _GroupedRows.apply(h, qs, bounds)


def snapshot_bounds(timestep: np.ndarray, steps: int) -> List[tuple]:
    """[(first row, end row)] of snapshots 1..steps in rows sorted by
    timestep; raises where the rows are not sorted or a timestep lies
    outside 1..steps."""
    t = np.asarray(timestep, np.int64)
    if t.size and (np.any(np.diff(t) < 0) or t.min() < 1 or t.max() > steps):
        raise ValueError(
            f"EvolveGCN-O needs every row's timestep in 1..{steps} and each timestep's "
            "rows contiguous, in order (the trainer's BFS order keeps them so)")
    ends = np.searchsorted(t, np.arange(1, steps + 1), side="right")
    starts = np.concatenate([[0], ends[:-1]])
    return [(int(a), int(b)) for a, b in zip(starts, ends)]


def check_snapshots(data, steps: int) -> None:
    """Set-up's check of the graph the model trains on: no edge joins two
    timesteps (so the aggregation stays within each snapshot), and the rows
    are in timestep order, each timestep contiguous."""
    ts = np.asarray(data.timestep, np.int64)
    ei = np.asarray(data.edge_index, np.int64)
    if ei.size and np.any(ts[ei[0]] != ts[ei[1]]):
        n = int(np.count_nonzero(ts[ei[0]] != ts[ei[1]]))
        raise ValueError(f"EvolveGCN-O needs every edge within one timestep: {n} edges "
                         "join two timesteps")
    snapshot_bounds(ts, steps)


def check_route(cfg: dict, aggregation: str, n_mesh: int) -> None:
    """EvolveGCN-O trains full-batch on one device over the BSDA tables:
    the ELL encoding (renumber_for_ell does not keep timesteps contiguous),
    `mini_batch` (a sampled subgraph is no sequence of snapshots) and
    meshes (no sharded chain) refuse it."""
    if cfg.get("mini_batch", False):
        raise ValueError("arch egcn_o trains full-batch only: mini_batch: true is not "
                         "supported (a sampled subgraph is no sequence of snapshots)")
    if n_mesh > 1 or aggregation == "shard_map":
        raise ValueError("arch egcn_o runs on one device: mesh_devices > 1 and "
                         "aggregation: shard_map are not supported")
    if aggregation == "ell":
        raise ValueError("arch egcn_o needs the BSDA tables: aggregation: ell is not "
                         "supported (renumber_for_ell does not keep each timestep's rows "
                         "contiguous)")


class EvolveGCNO(nn.Module):
    """EvolveGCN-O (module docstring). cfg keys: hidden_dim (the GRCU
    layers' width), layers (GRCU layers), cls_feats (the classifier's
    hidden width), max_timestep (snapshots, the chain's steps)."""

    uses_time_embed = True  # the trainer hands it each row's timestep

    def __init__(self, in_dim: int, cfg: dict, generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = int(cfg.get("hidden_dim", 256))
        layers = int(cfg.get("layers", 2))
        cls_feats = int(cfg.get("cls_feats", hidden))
        if layers < 1:
            raise ValueError(f"layers must be >= 1, got {layers}")
        self.steps = int(cfg.get("max_timestep", 49))
        dims = [in_dim] + [hidden] * layers
        self.grcu = nn.ModuleList(GRCU(dims[i], dims[i + 1], generator) for i in range(layers))
        self.cls = nn.ModuleList([_linear(hidden, cls_feats, True, generator),
                                  _linear(cls_feats, 2, True, generator)])
        self._bounds_of = None
        self._bounds = None

    def bounds(self, t_idx: torch.Tensor) -> List[tuple]:
        """The snapshots' row ranges of `t_idx`, read to the host once per
        tensor (never inside a CUDA-graph capture: the K loop's eager first
        epoch reads them)."""
        if t_idx is None:
            raise ValueError("EvolveGCN-O needs each row's timestep (t_idx)")
        key = (t_idx.data_ptr(), t_idx.numel(), str(t_idx.device))
        if self._bounds_of != key:
            if t_idx.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("EvolveGCN-O reads the snapshots' row ranges on the host: "
                                   "run an epoch before capturing one")
            self._bounds = snapshot_bounds(t_idx.detach().cpu().numpy(), self.steps)
            self._bounds_of = key
        return self._bounds

    def forward(self, x: torch.Tensor, g, t_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                row_mask: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
        if row_mask is not None or group is not None:
            raise ValueError("arch egcn_o runs on one device (no row_mask, no group)")
        bounds = self.bounds(t_idx)
        if not x.is_cuda:
            return self.forward_plain(x, g, bounds)
        h = x
        for layer in self.grcu:
            qs = evolve(layer.params(), self.steps)
            h = torch.nn.functional.leaky_relu(spmm(g, grouped_rows_mm(h, qs, bounds)), SLOPE)
        return self.classify(h)

    def forward_plain(self, x: torch.Tensor, g, bounds) -> torch.Tensor:
        """The model in ATen ops, differentiated by autograd: the chain by
        evolve_plain, the grouped product as one product a snapshot. The
        CPU's path and the kernels' yardstick."""
        h = x
        for layer in self.grcu:
            qs = evolve_plain(layer.params(), self.steps)
            y = torch.cat([h[a:b] @ qs[t] for t, (a, b) in enumerate(bounds)])
            h = torch.nn.functional.leaky_relu(spmm(g, y), SLOPE)
        return self.classify(h)

    def classify(self, h: torch.Tensor) -> torch.Tensor:
        return self.cls[1](torch.relu(self.cls[0](h)))
