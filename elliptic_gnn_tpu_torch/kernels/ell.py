"""ELL degree-bucketed graph encoding (port of elliptic_gnn_tpu/kernels/ell.py).

Destination rows are grouped into power-of-two degree buckets, each row's
neighbour list padded to the bucket width (padding weight 0). Aggregation is
a dense gather plus a weighted row sum per bucket, and one gather by the
inverse permutation puts rows back in node order (or none, after
renumber_for_ell). In the port it carries the BSDA residual spill
(kernels/bsda.py, kernels/bsda_gat.py), the explainer's subgraphs, and the
trainer's `aggregation: ell` and sampled mini-batch paths, which the JAX
package also runs as plain gathers outside any Pallas kernel.

The host-side build is numpy, identical to the JAX package's; the result
holds torch tensors (index tensors as int64, torch's index type).

The trainer's full-batch encodings (train_gnn.build_graph_ops) also carry
the flat form of the same rows and slots (EllTables: with_flat_tables),
and where a gradient runs its transpose: on CUDA tensors their aggregation
is one launch of the hand-written kernel (kernels/ell_spmm_cuda.py), its
gradient the same kernel on the transpose. Encodings without them (the
spill, the sampler's batches, the explainer's subgraphs) keep the
gathers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.common import upload
from .encoding import GraphEncoding


@dataclasses.dataclass
class EllTables:
    """The flat (CSR) form of an aggregation, as kernels/ell_spmm_cuda.py
    reads it:

        out[d] = scale[d] * sum_{row_ptr[d] <= e < row_ptr[d + 1]} weight[e] * x[col[e]]

    row_ptr: [n_rows + 1] int32; col: [nnz] int32 rows of x (n_src of
    them); weight: [nnz] float32; scale: [n_rows] float32, or None (ones);
    long_rows: int32, the rows of more than LONG_DEGREE entries (the kernel
    gives each a block of its own).
    """

    row_ptr: torch.Tensor
    col: torch.Tensor
    weight: torch.Tensor
    scale: Optional[torch.Tensor]
    long_rows: torch.Tensor
    n_src: int

    @property
    def n_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    def to(self, device) -> "EllTables":
        return dataclasses.replace(
            self, row_ptr=upload(self.row_ptr, device), col=upload(self.col, device),
            weight=upload(self.weight, device),
            scale=None if self.scale is None else upload(self.scale, device),
            long_rows=upload(self.long_rows, device))


@dataclasses.dataclass
class EllGraph(GraphEncoding):
    """nbrs:      tuple of [R_b, W_b] int64 — source ids per destination row
    weights:   tuple of [R_b, W_b] float32 — edge weights; 0 marks padding
    rows:      tuple of [R_b] int64 — destination node id of each row
    inv_perm:  [N] int64 — node id -> position in the concatenated row order
    row_scale: tuple of [R_b] float32 — per-row post-scale (1/deg for mean)
    num_nodes, widths, n_zero_deg: static sizes
    flat:      the same aggregation as EllTables over node ids (with_flat_tables)
    flat_t:    its transpose, for the gradient; both None where not built.
    A replace() of the bucket tables must drop them.
    """

    nbrs: Tuple[torch.Tensor, ...]
    weights: Tuple[torch.Tensor, ...]
    rows: Tuple[torch.Tensor, ...]
    inv_perm: Optional[torch.Tensor]
    row_scale: Tuple[torch.Tensor, ...]
    num_nodes: int
    widths: Tuple[int, ...]
    n_zero_deg: int
    flat: Optional[EllTables] = None
    flat_t: Optional[EllTables] = None

    def to(self, device) -> "EllGraph":
        def mv(t):
            return None if t is None else upload(t, device)

        return dataclasses.replace(
            self,
            nbrs=tuple(mv(t) for t in self.nbrs),
            weights=tuple(mv(t) for t in self.weights),
            rows=tuple(mv(t) for t in self.rows),
            inv_perm=mv(self.inv_perm),
            row_scale=tuple(mv(t) for t in self.row_scale),
            flat=None if self.flat is None else self.flat.to(device),
            flat_t=None if self.flat_t is None else self.flat_t.to(device),
        )

    def spmm(self, x, compute_dtype=None):
        """At full precision whatever `compute_dtype` says, as the JAX
        package runs its ELL path: with the flat tables on CUDA tensors the
        kernel (it launches or raises), else the ELL gather."""
        if self.flat is not None and x.is_cuda:
            from .ell_spmm_cuda import ell_spmm_cuda

            return ell_spmm_cuda(self, x)
        return ell_spmm(self, x)

    def gat_attend(self, x_proj, alpha_src, alpha_dst, negative_slope=0.2):
        return ell_gat_aggregate(self, x_proj, alpha_src, alpha_dst, negative_slope)


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


# a row of more entries than this takes a block of the kernel's own
LONG_DEGREE = 32


def _tables(row_ptr, col, weight, scale, n_src: int) -> EllTables:
    long_rows = np.nonzero(np.diff(row_ptr) > LONG_DEGREE)[0]
    return EllTables(row_ptr=torch.from_numpy(row_ptr.astype(np.int32)),
                     col=torch.from_numpy(col.astype(np.int32)),
                     weight=torch.from_numpy(weight.astype(np.float32)),
                     scale=None if scale is None else torch.from_numpy(scale),
                     long_rows=torch.from_numpy(long_rows.astype(np.int32)), n_src=n_src)


def flat_tables(g: EllGraph) -> EllTables:
    """g's aggregation as EllTables over node ids (on the CPU): each
    bucket row's slots in slot order, padding slots (weight 0) left out,
    the row scale per node (ones for zero-degree rows, which sum nothing)."""
    n = g.num_nodes
    dst, src, wgt = [], [], []
    scale = np.ones(n, dtype=np.float32)
    for nbr, w, rows, rs in zip(g.nbrs, g.weights, g.rows, g.row_scale):
        w = w.cpu().numpy()
        rows = rows.cpu().numpy()
        valid = w != 0
        dst.append(np.repeat(rows, valid.sum(axis=1)))  # row-major: slot order
        src.append(nbr.cpu().numpy()[valid])
        wgt.append(w[valid])
        scale[rows] = rs.cpu().numpy()
    dst = np.concatenate(dst) if dst else np.zeros(0, np.int64)
    src = np.concatenate(src) if src else np.zeros(0, np.int64)
    wgt = np.concatenate(wgt) if wgt else np.zeros(0, np.float32)
    row_ptr, col, order = build_csr(src, dst, n)  # stable: slot order kept
    return _tables(row_ptr, col, wgt[order], scale, n)


def transpose_tables(t: EllTables) -> EllTables:
    """A^T of t (on the CPU): an entry d <- s of weight w becomes s <- d of
    weight w * scale[d], no scale; a source's entries in t's order."""
    rp = t.row_ptr.cpu().numpy().astype(np.int64)
    n_rows = rp.shape[0] - 1
    dst = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(rp))
    src = t.col.cpu().numpy().astype(np.int64)
    w = t.weight.cpu().numpy()
    if t.scale is not None:
        w = w * t.scale.cpu().numpy()[dst]
    row_ptr, col, order = build_csr(dst, src, t.n_src)
    return _tables(row_ptr, col, w[order], None, n_rows)


def with_flat_tables(g: EllGraph, transpose: bool) -> EllGraph:
    """g with its flat tables, and with `transpose` their transpose (the
    gradient's): the encoding's aggregation then runs the kernel on CUDA
    tensors. Build after any relabelling (renumber_for_ell)."""
    flat = flat_tables(g)
    return dataclasses.replace(g, flat=flat,
                               flat_t=transpose_tables(flat) if transpose else None)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for an index tensor of any shape, through index_select: its
    backward is one index_add_ (atomics), where x[idx]'s sorts the indices
    and sums each run of equal ones in a single warp. Every padding slot of
    an ELL row points at node 0, so that run is long: a sampled batch's
    203,769 x 21 table holds millions (the sorting backward took ~6 s a
    step on an H100)."""
    return x.index_select(0, idx.reshape(-1)).view(*idx.shape, *x.shape[1:])


def ell_weighted_sum(g: EllGraph, x: torch.Tensor) -> torch.Tensor:
    """f32 [N_rows, F] = row_scale[d] * sum_e w_e * x[src_e].

    Products are taken in x's dtype (weights rounded to it, as the JAX
    einsum does) and accumulated in f32."""
    feat = x.shape[-1]
    outs = []
    for nbr, w, scale in zip(g.nbrs, g.weights, g.row_scale):
        gathered = gather_rows(x, nbr).float()  # [R, W, F]
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
        scores = gather_rows(alpha_src, nbr) + alpha_dst[rows][:, None, :]  # [R, W, H]
        scores = torch.nn.functional.leaky_relu(scores, negative_slope)
        scores = torch.where(valid, scores, scores.new_full((), -torch.inf))
        smax = scores.amax(dim=1, keepdim=True)
        smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
        ex = torch.exp(scores - smax) * valid
        att = ex / ex.sum(dim=1, keepdim=True).clamp_min(1e-16)
        outs.append(torch.einsum("rwh,rwhc->rhc", att, gather_rows(x_proj, nbr)))
    if g.n_zero_deg:
        outs.append(x_proj.new_zeros((g.n_zero_deg, h, c)))
    permuted = torch.cat(outs, dim=0)
    if g.inv_perm is None:
        return permuted
    return permuted[g.inv_perm]


def renumber_for_ell(g: EllGraph):
    """Relabel nodes so the concatenated bucket-row order IS the node order.

    Returns (g_renumbered, rank) with rank[old_id] = new_id (int32, as the
    JAX package's). Aggregation on the renumbered graph skips its final
    reorder gather (inv_perm None). Apply `rank` to every per-node array
    (GraphData.renumber), which keeps the way back for the artifacts."""
    if g.inv_perm is None:
        return g, np.arange(g.num_nodes, dtype=np.int32)
    rank = g.inv_perm.cpu().numpy().astype(np.int64)
    rank_t = torch.from_numpy(rank)
    g2 = dataclasses.replace(
        g,
        nbrs=tuple(rank_t[n.cpu()].to(n.device) for n in g.nbrs),
        rows=tuple(rank_t[r.cpu()].to(r.device) for r in g.rows),
        inv_perm=None, flat=None, flat_t=None,
    )
    return g2, rank.astype(np.int32)


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
