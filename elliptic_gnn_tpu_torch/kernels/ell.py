"""ELL degree-bucketed graph encoding (port of elliptic_gnn_tpu/kernels/ell.py).

Destination rows are grouped into power-of-two degree buckets, each row's
neighbour list padded to the bucket width (padding weight 0). Aggregation is
a dense gather plus a weighted row sum per bucket, and one gather by the
inverse permutation puts rows back in node order. In the port it carries
the BSDA residual spill (kernels/bsda.py, kernels/bsda_gat.py) and serves
as a plain reference.

The host-side build is numpy, identical to the JAX package's; the result
holds torch tensors (index tensors as int64, torch's index type).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class EllGraph:
    """nbrs:      tuple of [R_b, W_b] int64 — source ids per destination row
    weights:   tuple of [R_b, W_b] float32 — edge weights; 0 marks padding
    rows:      tuple of [R_b] int64 — destination node id of each row
    inv_perm:  [N] int64 — node id -> position in the concatenated row order
    row_scale: tuple of [R_b] float32 — per-row post-scale (1/deg for mean)
    num_nodes, widths, n_zero_deg: static sizes
    """

    nbrs: Tuple[torch.Tensor, ...]
    weights: Tuple[torch.Tensor, ...]
    rows: Tuple[torch.Tensor, ...]
    inv_perm: Optional[torch.Tensor]
    row_scale: Tuple[torch.Tensor, ...]
    num_nodes: int
    widths: Tuple[int, ...]
    n_zero_deg: int

    def to(self, device) -> "EllGraph":
        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self,
            nbrs=tuple(mv(t) for t in self.nbrs),
            weights=tuple(mv(t) for t in self.weights),
            rows=tuple(mv(t) for t in self.rows),
            inv_perm=mv(self.inv_perm),
            row_scale=tuple(mv(t) for t in self.row_scale),
        )


def build_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """Sort edges by destination: (indptr [N+1], col [E], order [E]) with
    `order` mapping CSR position -> original edge id. Native counting sort
    when the library is built."""
    from ..native import build_csr as native_csr, is_available

    if is_available():
        indptr, col, order = native_csr(src, dst, num_nodes)
        return indptr, col.astype(np.int32), order
    order = np.argsort(dst, kind="stable")
    col = src[order].astype(np.int32)
    counts = np.bincount(dst, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, col, order


def build_ell_graph(
    edge_index: np.ndarray,
    num_nodes: int,
    edge_weights: Optional[np.ndarray] = None,
    mean: bool = False,
    max_width: int = 1 << 14,
    min_width: int = 1,
) -> EllGraph:
    """Host-side one-time pack of a directed edge list into EllGraph
    (same buckets, order and padding as the JAX package's builder)."""
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    e = src.size
    if edge_weights is None:
        w_all = np.ones(e, dtype=np.float32)
    else:
        w_all = np.asarray(edge_weights, dtype=np.float32)

    indptr, col, order = build_csr(src, dst, num_nodes)
    w_csr = w_all[order]
    deg = np.diff(indptr)

    widths_per_node = np.zeros_like(deg)
    nz = deg > 0
    widths_per_node[nz] = 1 << np.ceil(
        np.log2(np.maximum(deg[nz], 1))
    ).astype(np.int64)
    if min_width > 1:
        widths_per_node[nz] = np.maximum(widths_per_node[nz], min_width)
    uniq_widths = sorted(set(int(w) for w in widths_per_node if w > 0))
    for w in uniq_widths:
        if w > max_width:
            raise ValueError(f"node degree bucket {w} exceeds max_width={max_width}")

    nbrs, weights, rows_list, row_scales = [], [], [], []
    perm_parts = []
    for w in uniq_widths:
        rows = np.where(widths_per_node == w)[0]
        rb = rows.size
        nbr = np.zeros((rb, w), dtype=np.int64)
        wgt = np.zeros((rb, w), dtype=np.float32)
        d_rows = deg[rows]
        total = int(d_rows.sum())
        if total:
            seg_starts = np.repeat(indptr[rows], d_rows)
            within = np.arange(total) - np.repeat(
                np.cumsum(np.r_[0, d_rows[:-1]]), d_rows
            )
            src_pos = seg_starts + within
            row_pos = np.repeat(np.arange(rb), d_rows)
            nbr[row_pos, within] = col[src_pos]
            wgt[row_pos, within] = w_csr[src_pos]
        scale = (
            (1.0 / np.maximum(deg[rows], 1)).astype(np.float32)
            if mean
            else np.ones(rb, dtype=np.float32)
        )
        nbrs.append(torch.from_numpy(nbr))
        weights.append(torch.from_numpy(wgt))
        rows_list.append(torch.from_numpy(rows.astype(np.int64)))
        row_scales.append(torch.from_numpy(scale))
        perm_parts.append(rows)

    zero_rows = np.where(deg == 0)[0]
    perm_parts.append(zero_rows)
    perm = np.concatenate(perm_parts) if perm_parts else np.arange(num_nodes)
    inv_perm = np.empty(num_nodes, dtype=np.int64)
    inv_perm[perm] = np.arange(num_nodes, dtype=np.int64)

    return EllGraph(
        nbrs=tuple(nbrs),
        weights=tuple(weights),
        rows=tuple(rows_list),
        inv_perm=torch.from_numpy(inv_perm),
        row_scale=tuple(row_scales),
        num_nodes=int(num_nodes),
        widths=tuple(uniq_widths),
        n_zero_deg=int(zero_rows.size),
    )


def ell_weighted_sum(g: EllGraph, x: torch.Tensor) -> torch.Tensor:
    """f32 [N_rows, F] = row_scale[d] * sum_e w_e * x[src_e].

    Products are taken in x's dtype (weights rounded to it, as the JAX
    einsum does) and accumulated in f32."""
    feat = x.shape[-1]
    outs = []
    for nbr, w, scale in zip(g.nbrs, g.weights, g.row_scale):
        gathered = x[nbr].float()  # [R, W, F]
        wq = w.to(x.dtype).float()
        agg = torch.einsum("rw,rwf->rf", wq, gathered)
        outs.append(agg * scale[:, None])
    if g.n_zero_deg:
        outs.append(torch.zeros((g.n_zero_deg, feat), dtype=torch.float32,
                                device=x.device))
    permuted = torch.cat(outs, dim=0) if outs else torch.zeros(
        (0, feat), dtype=torch.float32, device=x.device)
    if g.inv_perm is None:
        return permuted
    return permuted[g.inv_perm]


def ell_spmm(g: EllGraph, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Plain aggregation out[d] = row_scale[d] * sum_e w_e x[src_e], in x's
    dtype (optional bf16 operands with f32 accumulation)."""
    xg = x.to(compute_dtype) if compute_dtype is not None else x
    return ell_weighted_sum(g, xg).to(x.dtype)


def ell_gat_aggregate(g: EllGraph, x_proj: torch.Tensor,
                      alpha_src: torch.Tensor, alpha_dst: torch.Tensor,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """GAT attention over an ELL graph: x_proj [N, H, C], alpha_src and
    alpha_dst [N, H] -> [N_rows, H, C], the per-destination
    softmax-weighted neighbour sum. Each destination's incoming edges fill
    one padded row, so the segment softmax is a masked softmax over the row
    width. Weights mark validity only (> 0)."""
    n, h, c = x_proj.shape
    outs = []
    for nbr, w, rows in zip(g.nbrs, g.weights, g.rows):
        valid = (w > 0)[..., None]  # [R, W, 1]
        scores = alpha_src[nbr] + alpha_dst[rows][:, None, :]  # [R, W, H]
        scores = torch.nn.functional.leaky_relu(scores, negative_slope)
        scores = torch.where(valid, scores, scores.new_full((), -torch.inf))
        smax = scores.amax(dim=1, keepdim=True)
        smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
        ex = torch.exp(scores - smax) * valid
        att = ex / ex.sum(dim=1, keepdim=True).clamp_min(1e-16)
        outs.append(torch.einsum("rwh,rwhc->rhc", att, x_proj[nbr]))
    if g.n_zero_deg:
        outs.append(x_proj.new_zeros((g.n_zero_deg, h, c)))
    permuted = torch.cat(outs, dim=0)
    if g.inv_perm is None:
        return permuted
    return permuted[g.inv_perm]


def gcn_norm_weights(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Symmetric GCN normalization weights per edge, PyG gcn_norm convention:
    degrees counted from the destination column over edges incl. self-loops
    (caller must have appended self-loops first); w_e = d[src]^-1/2 d[dst]^-1/2.
    """
    dst = edge_index[1]
    deg = np.bincount(dst, minlength=num_nodes).astype(np.float64)
    dinv = np.zeros_like(deg)
    nz = deg > 0
    dinv[nz] = deg[nz] ** -0.5
    return (dinv[edge_index[0]] * dinv[dst]).astype(np.float32)
