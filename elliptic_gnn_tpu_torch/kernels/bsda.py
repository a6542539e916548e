"""BSDA — Block-Sparse Dense Aggregation (port of elliptic_gnn_tpu/kernels/bsda.py).

Nodes are BFS-ordered within each timestep block and cut into chunks of
C=128. Each destination chunk keeps its top-D source chunks as dense C x C
blocks of edge weights,

    out[b] = sum_d A[b, d] @ x[src_chunk[b, d]],

and edges outside those chunk pairs spill to a small residual ELL whose
output is added with one index-add.

This module holds the numpy table builder (the same tables as the JAX
builder, turned into torch tensors at the end), the plain PyTorch SpMM that
is the reference for the CUDA kernel (kernels/bsda_spmm_cuda.py), and the
autograd rule shared by both: the gradient of A @ x is A^T @ ct, computed by
the same forward on the transpose tables.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.common import upload

from .ell import EllGraph, build_ell_graph, ell_weighted_sum, gcn_norm_weights
from .encoding import GraphEncoding

CHUNK = 128

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


@dataclasses.dataclass
class BsdaGraph(GraphEncoding):
    """a: [B, D, C, C] dense blocks — a[b, d, i, j] is the weight of edge
    (src_chunk[b,d]*C + j) -> (b*C + i); zero blocks padded.
    src_chunk: [B, D] int32 source-chunk ids (self-pointing for padding).
    residual: EllGraph over compacted destination rows (spill edges);
    residual_rows [R] int64 maps compact row -> node id.
    transpose: the A^T encoding used for gradients.
    dst_scale/src_scale: [B*C] f32 factored scales (a_dtype int8): the true
    weight is dst_scale[dst] * src_scale[src] * a; None means ones.
    a_packed: [B, ceil(D/a_pack), C, C] uint8 bit-planes, slot d in plane
    d // a_pack at bit offset (8 // a_pack) * (d % a_pack).
    slot_occ: [B] int32, 1 + last nonzero slot per chunk.
    """

    a: torch.Tensor
    src_chunk: torch.Tensor
    residual: Optional[EllGraph]
    residual_rows: Optional[torch.Tensor]
    num_nodes: int
    num_chunks: int
    depth: int
    n_pad: int
    a_dtype_name: str
    chunk: int = CHUNK
    transpose: Optional["BsdaGraph"] = None
    max_chunk_dist: int = 0
    dst_scale: Optional[torch.Tensor] = None
    src_scale: Optional[torch.Tensor] = None
    a_packed: Optional[torch.Tensor] = None
    a_pack: int = 1
    slot_occ: Optional[torch.Tensor] = None

    def to(self, device) -> "BsdaGraph":
        """A copy with every table on `device`."""

        def mv(t):
            return None if t is None else upload(t, device)

        return dataclasses.replace(
            self,
            a=mv(self.a),
            src_chunk=mv(self.src_chunk),
            residual=None if self.residual is None else self.residual.to(device),
            residual_rows=mv(self.residual_rows),
            transpose=None if self.transpose is None else self.transpose.to(device),
            dst_scale=mv(self.dst_scale),
            src_scale=mv(self.src_scale),
            a_packed=mv(self.a_packed),
            slot_occ=mv(self.slot_occ),
        )

    def spmm(self, x, compute_dtype=None):
        """The CUDA kernel for CUDA tensors (it launches or raises), the
        plain version for CPU tensors."""
        if x.is_cuda:
            from .bsda_spmm_cuda import bsda_spmm_cuda

            return bsda_spmm_cuda(self, x, compute_dtype=compute_dtype)
        return bsda_spmm(self, x, compute_dtype=compute_dtype)

    def gat_attend(self, x_proj, alpha_src, alpha_dst, negative_slope=0.2):
        """The chunk-pair formulation (kernels/bsda_gat.py): the CPU path
        and the packed kernels' yardstick."""
        from .bsda_gat import bsda_gat_aggregate

        return bsda_gat_aggregate(self, x_proj, alpha_src, alpha_dst, negative_slope)

    def packed_gat_route(self):
        """The whole graph's rows through the GAT kernels: attend_rows of
        payload [N_pad, W] -> [N_pad, W]."""
        from .packed_gat import DenseTables, attend_rows

        return (self.num_chunks * self.chunk,
                lambda p, h, ch, s: attend_rows(DenseTables(self), p, h, ch, s))

    def gat_runs_packed(self, x) -> bool:
        """Packed on CUDA tensors; CPU tensors take the plain formulation."""
        return x.is_cuda


# ---------------- host-side table builder (numpy) ----------------

def pack_a_planes(a_np: np.ndarray, pack: int) -> np.ndarray:
    """[B, D, C, C] small non-negative ints -> [B, ceil(D/pack), C, C]
    uint8 bit-planes; slot d is stored in plane d // pack at bit offset
    (8 // pack) * (d % pack). Requires every value < 2 ** (8 // pack)."""
    b, d, c, c2 = a_np.shape
    bits = 8 // pack
    planes = -(-d // pack)
    padded = np.zeros((b, planes * pack, c, c2), np.uint8)
    padded[:, :d] = a_np.astype(np.uint8)
    padded = padded.reshape(b, planes, pack, c, c2)
    out = np.zeros((b, planes, c, c2), np.uint8)
    for s in range(pack):
        out |= padded[:, :, s] << np.uint8(bits * s)
    return out


def _auto_pack(a_np: np.ndarray, depth: int) -> int:
    """Densest lossless packing for an integer multiplicity table:
    4 slots/byte when every value < 4, 2 when < 16, else 1."""
    if depth < 2:
        return 1
    mx = int(a_np.max()) if a_np.size else 0
    if mx < 4:
        return 4
    if mx < 16:
        return 2
    return 1


def bfs_order(edge_index: np.ndarray, num_nodes: int,
              block_ids: np.ndarray) -> np.ndarray:
    """rank[old_id] = new_id: BFS order over the undirected graph within
    each block (components contiguous), blocks kept in order.

    Node ids not sorted by block are first relabelled into (block, id)
    order. Uses the native C++ BFS (native/egnn_native.cpp) when built, the
    Python BFS below otherwise — the same two implementations as the JAX
    package, so both packages give the same ranks."""
    block_ids = np.asarray(block_ids)
    if block_ids.size == num_nodes and np.any(np.diff(block_ids) < 0):
        relabel = np.argsort(
            np.argsort(block_ids, kind="stable"), kind="stable"
        ).astype(np.int64)
        ei_rel = relabel[np.asarray(edge_index, np.int64)]
        rank_rel = bfs_order(ei_rel, num_nodes, block_ids[np.argsort(relabel)])
        return rank_rel[relabel].astype(np.int32)

    from ..native import bfs_order as native_bfs

    rank_c = native_bfs(edge_index[0], edge_index[1], num_nodes)
    if rank_c is not None:
        return rank_c

    src = np.asarray(edge_index[0], np.int64)
    dst = np.asarray(edge_index[1], np.int64)
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    order_e = np.argsort(u, kind="stable")
    v_s = v[order_e]
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(u[order_e], minlength=num_nodes), out=indptr[1:])

    rank = np.full(num_nodes, -1, np.int64)
    nxt = 0
    visited = np.zeros(num_nodes, bool)
    for start in range(num_nodes):
        if visited[start]:
            continue
        visited[start] = True
        q = deque([start])
        while q:
            n = q.popleft()
            rank[n] = nxt
            nxt += 1
            for p in range(indptr[n], indptr[n + 1]):
                m = v_s[p]
                if not visited[m]:
                    visited[m] = True
                    q.append(m)
    return rank.astype(np.int32)


def build_bsda(
    edge_index: np.ndarray,
    num_nodes: int,
    edge_weights: Optional[np.ndarray] = None,
    mean: bool = False,
    depth: int = 2,
    a_dtype: str = "float32",
    chunk: int = CHUNK,
    residual_weights: Optional[np.ndarray] = None,
    dst_scale: Optional[np.ndarray] = None,
    src_scale: Optional[np.ndarray] = None,
) -> BsdaGraph:
    """Pack a (BFS-renumbered) graph into dense chunk blocks + residual.

    Factored-scale form (a_dtype "int8"): integer `edge_weights`
    (multiplicities) plus `dst_scale`/`src_scale` [num_nodes] vectors, and
    the true float weights as `residual_weights` for the spill edges."""
    src = np.asarray(edge_index[0], np.int64)
    dst = np.asarray(edge_index[1], np.int64)
    e = src.size
    w_all = (
        np.ones(e, np.float32)
        if edge_weights is None
        else np.asarray(edge_weights, np.float32)
    )
    if mean:
        deg = np.bincount(dst, minlength=num_nodes)
        w_all = w_all / np.maximum(deg[dst], 1).astype(np.float32)
    w_res = (
        w_all if residual_weights is None
        else np.asarray(residual_weights, np.float32)
    )

    b = (num_nodes + chunk - 1) // chunk
    n_padded = b * chunk
    bsrc = src // chunk
    bdst = dst // chunk

    # per destination chunk: count edges per source chunk, keep the top-D
    pair_key = bdst * b + bsrc
    uniq_pairs, pair_inv, pair_cnt = np.unique(
        pair_key, return_inverse=True, return_counts=True
    )
    p_dst = (uniq_pairs // b).astype(np.int64)
    p_src = (uniq_pairs % b).astype(np.int64)

    src_chunk = np.tile(np.arange(b, dtype=np.int64)[:, None], (1, depth))
    order_p = np.lexsort((-pair_cnt, p_dst))
    fill = np.zeros(b, np.int64)
    keep_pair = p_src == p_dst  # diagonal always dense (slot 0 reserved)
    for pi in order_p:
        d = p_dst[pi]
        if keep_pair[pi]:
            continue
        if fill[d] < depth - 1:
            keep_pair[pi] = True
            fill[d] += 1

    slot_of_pair = np.full(uniq_pairs.size, -1, np.int64)
    next_slot = np.ones(b, np.int64)  # slot 0 = diagonal
    for pi in order_p:
        if not keep_pair[pi]:
            continue
        d = p_dst[pi]
        if p_src[pi] == d:
            slot_of_pair[pi] = 0
        else:
            slot_of_pair[pi] = next_slot[d]
            src_chunk[d, next_slot[d]] = p_src[pi]
            next_slot[d] += 1

    a = np.zeros((b, depth, chunk, chunk), np.float32)
    e_slot = slot_of_pair[pair_inv]
    in_dense = e_slot >= 0
    np.add.at(
        a,
        (bdst[in_dense], e_slot[in_dense], dst[in_dense] % chunk,
         src[in_dense] % chunk),
        w_all[in_dense],
    )

    residual = None
    residual_rows = None
    n_spill = int((~in_dense).sum())
    if n_spill:
        r_src = src[~in_dense]
        r_dst = dst[~in_dense]
        rows, r_dst_compact = np.unique(r_dst, return_inverse=True)
        r_ei = np.stack([r_src, r_dst_compact])
        residual = build_ell_graph(
            r_ei, rows.size, edge_weights=w_res[~in_dense], mean=False
        )
        residual_rows = torch.from_numpy(rows.astype(np.int64))
    print(
        f"[BSDA] chunks={b} depth={depth} dense_edges={int(in_dense.sum())} "
        f"spill_edges={n_spill} ({n_spill / max(e, 1):.1%})"
    )

    def pad_scale(s):
        if s is None:
            return None
        out = np.zeros(n_padded, np.float32)
        out[:num_nodes] = np.asarray(s, np.float32)
        return torch.from_numpy(out)

    # bit-packed planes for the kernel (int8 multiplicity tables only)
    a_pack = 1
    a_packed = None
    if a_dtype == "int8":
        a_int = a.astype(np.int64)
        a_pack = _auto_pack(a_int, depth)
        if a_pack > 1:
            a_packed = torch.from_numpy(pack_a_planes(a_int, a_pack))

    nz_slots = a.reshape(b, depth, -1).any(axis=-1)
    slot_occ = np.max(
        np.where(nz_slots, np.arange(1, depth + 1, dtype=np.int64)[None, :], 0),
        axis=1,
    ).astype(np.int32)

    return BsdaGraph(
        a=torch.from_numpy(a).to(_TORCH_DTYPE[a_dtype]),
        a_packed=a_packed,
        a_pack=a_pack,
        src_chunk=torch.from_numpy(src_chunk.astype(np.int32)),
        residual=residual,
        residual_rows=residual_rows,
        num_nodes=num_nodes,
        num_chunks=b,
        depth=depth,
        n_pad=n_padded - num_nodes,
        a_dtype_name=a_dtype,
        chunk=chunk,
        max_chunk_dist=int(
            np.abs(src_chunk - np.arange(b, dtype=np.int64)[:, None]).max()
        ) if b else 0,
        dst_scale=pad_scale(dst_scale),
        src_scale=pad_scale(src_scale),
        slot_occ=torch.from_numpy(slot_occ),
    )


def with_transpose(g: BsdaGraph, edge_index: np.ndarray, num_nodes: int,
                   edge_weights: Optional[np.ndarray], mean: bool) -> BsdaGraph:
    """Attach the A^T encoding (reversed edges, identical folded weights)."""
    w_all = (
        np.ones(edge_index.shape[1], np.float32)
        if edge_weights is None
        else np.asarray(edge_weights, np.float32)
    )
    if mean:
        deg = np.bincount(edge_index[1], minlength=num_nodes)
        w_all = w_all / np.maximum(deg[edge_index[1]], 1).astype(np.float32)
    rev = np.stack([edge_index[1], edge_index[0]])
    g_t = build_bsda(rev, num_nodes, edge_weights=w_all, mean=False,
                     depth=g.depth, a_dtype=g.a_dtype_name, chunk=g.chunk)
    return dataclasses.replace(g, transpose=g_t)


def _with_transpose_factored(g: BsdaGraph, edge_index: np.ndarray,
                             num_nodes: int, mult: np.ndarray,
                             true_w: np.ndarray, dst_scale, src_scale,
                             ) -> BsdaGraph:
    """A^T of a factored encoding: reversed edges, multiplicities unchanged,
    row/column scales swap roles."""
    rev = np.stack([edge_index[1], edge_index[0]])
    g_t = build_bsda(
        rev, num_nodes, edge_weights=mult, mean=False, depth=g.depth,
        a_dtype=g.a_dtype_name, chunk=g.chunk, residual_weights=true_w,
        dst_scale=src_scale, src_scale=dst_scale,
    )
    return dataclasses.replace(g, transpose=g_t)


def build_bsda_for_kind(edge_index: np.ndarray, num_nodes: int, kind: str,
                        depth: int = 2, a_dtype: str = "float32",
                        transpose: bool = True) -> BsdaGraph:
    """Model-kind wrapper: 'sage' mean aggregation, 'gcn' self-loops with
    symmetric normalization, 'gat' self-loops with unit weights (always
    int8 multiplicities; attention is computed by the caller). a_dtype
    "int8" selects the factored-scale encoding (integer multiplicities in
    `a` + per-node scale vectors)."""
    from ..graph.transform import add_self_loops

    factored = a_dtype == "int8"
    if kind == "sage":
        if factored:
            dst = np.asarray(edge_index[1], np.int64)
            deg = np.bincount(dst, minlength=num_nodes)
            ds = 1.0 / np.maximum(deg, 1).astype(np.float32)
            mult = np.ones(edge_index.shape[1], np.float32)
            true_w = ds[dst]
            g = build_bsda(edge_index, num_nodes, edge_weights=mult,
                           mean=False, depth=depth, a_dtype=a_dtype,
                           residual_weights=true_w, dst_scale=ds)
            if transpose:
                g = _with_transpose_factored(
                    g, edge_index, num_nodes, mult, true_w, ds, None)
            return g
        g = build_bsda(edge_index, num_nodes, mean=True, depth=depth,
                       a_dtype=a_dtype)
        if transpose:
            g = with_transpose(g, edge_index, num_nodes, None, mean=True)
        return g
    if kind == "gcn":
        ei = add_self_loops(edge_index, num_nodes)
        w = gcn_norm_weights(ei, num_nodes)
        if factored:
            deg = np.bincount(np.asarray(ei[1], np.int64),
                              minlength=num_nodes).astype(np.float64)
            s = np.zeros_like(deg)
            nz = deg > 0
            s[nz] = deg[nz] ** -0.5
            s = s.astype(np.float32)
            mult = np.ones(ei.shape[1], np.float32)
            g = build_bsda(ei, num_nodes, edge_weights=mult, mean=False,
                           depth=depth, a_dtype=a_dtype, residual_weights=w,
                           dst_scale=s, src_scale=s)
            if transpose:
                g = _with_transpose_factored(g, ei, num_nodes, mult, w, s, s)
            return g
        g = build_bsda(ei, num_nodes, edge_weights=w, mean=False,
                       depth=depth, a_dtype=a_dtype)
        if transpose:
            g = with_transpose(g, ei, num_nodes, w, mean=False)
        return g
    if kind == "gat":
        # self-loops + unit weights: `a` holds edge multiplicities for the
        # attention kernels (kernels/gat_cuda.py) and their plain versions
        # (kernels/bsda_gat.py); always int8 (exact). The transpose is the
        # exact block transpose of the dense tables, so that the two-sweep
        # backward partitions the edges as the forward did (a transpose
        # built on its own would keep other chunk pairs dense).
        ei = add_self_loops(edge_index, num_nodes)
        g = build_bsda(ei, num_nodes, mean=False, depth=depth, a_dtype="int8")
        if transpose:
            g = dataclasses.replace(g, transpose=gat_block_transpose(g))
        return g
    raise ValueError(f"BSDA supports sage/gcn/gat, not {kind!r}")


def gat_block_transpose(g: BsdaGraph) -> BsdaGraph:
    """Exact block transpose of g's dense tables (no residual).

    For every kept dense pair (destination chunk I, slot d) with a nonzero
    block and source chunk J = src_chunk[I, d], the transpose holds
    aT[J, slot', j, i] = a[I, d, i, j] (each plane transposed) and
    srcT[J, slot'] = I, slots in increasing (I, d). Rows are then the
    sources of chunk J and columns the destinations of chunk I: the tables
    read like forward tables of the reversed edges (aT[J, s, j, i] is the
    multiplicity of the edge between row J*C + j and row srcT[J, s]*C + i),
    which is how the source sweep's kernel walks them. The JAX package's
    gat_block_transpose keeps the planes untransposed. Its depth is the
    largest number of references to one chunk; padding slots point a chunk
    at itself with zero multiplicities; slot_occ is the per-chunk reference
    count. The planes are bit-packed as the forward tables' are."""
    a = g.a.cpu().numpy()
    src = g.src_chunk.cpu().numpy().astype(np.int64)
    b, _, c, _ = a.shape
    i_chunk, d_i = np.nonzero(a.any(axis=(2, 3)))  # increasing (I, d)
    j_chunk = src[i_chunk, d_i]
    order = np.argsort(j_chunk, kind="stable")
    i_chunk, d_i, j_chunk = i_chunk[order], d_i[order], j_chunk[order]
    occ_t = np.bincount(j_chunk, minlength=b)
    slot = np.arange(j_chunk.size) - np.repeat(np.cumsum(occ_t) - occ_t, occ_t)
    dt = max(1, int(occ_t.max())) if b else 1
    a_t = np.zeros((b, dt, c, c), a.dtype)
    a_t[j_chunk, slot] = np.swapaxes(a[i_chunk, d_i], -1, -2)
    src_t = np.tile(np.arange(b, dtype=np.int32)[:, None], (1, dt))
    src_t[j_chunk, slot] = i_chunk
    pack = _auto_pack(a_t.astype(np.int64), dt)
    return BsdaGraph(
        a=torch.from_numpy(a_t),
        a_packed=(torch.from_numpy(pack_a_planes(a_t.astype(np.int64), pack))
                  if pack > 1 else None),
        a_pack=pack,
        src_chunk=torch.from_numpy(src_t),
        slot_occ=torch.from_numpy(occ_t.astype(np.int32)),
        residual=None,
        residual_rows=None,
        num_nodes=g.num_nodes,
        num_chunks=b,
        depth=dt,
        n_pad=g.n_pad,
        a_dtype_name=g.a_dtype_name,
        chunk=c,
        max_chunk_dist=int(np.abs(src_t - np.arange(b)[:, None]).max()) if b else 0,
    )


def pad_bsda_chunks(g: BsdaGraph, multiple: int) -> BsdaGraph:
    """The destination-chunk axis padded to a multiple (zero A-blocks,
    self-pointing sources, zero scales), so that the encoding tiles a group
    of ranks; the bit-packed planes, slot_occ and the transpose are padded
    alike. num_nodes is unchanged; callers pad node arrays to the new
    num_chunks * chunk grid."""
    b = g.num_chunks
    pad = (-b) % multiple
    if pad == 0:
        return g

    def cat_zeros(t):
        if t is None:
            return None
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))], dim=0)

    new_ids = torch.arange(b, b + pad, dtype=g.src_chunk.dtype,
                           device=g.src_chunk.device)

    def pad_scale(s):
        return None if s is None else torch.cat([s, s.new_zeros(pad * g.chunk)])

    return dataclasses.replace(
        g,
        a=cat_zeros(g.a),
        a_packed=cat_zeros(g.a_packed),
        src_chunk=torch.cat([g.src_chunk, new_ids[:, None].repeat(1, g.depth)]),
        num_chunks=b + pad,
        n_pad=g.n_pad + pad * g.chunk,
        dst_scale=pad_scale(g.dst_scale),
        src_scale=pad_scale(g.src_scale),
        slot_occ=cat_zeros(g.slot_occ),
        transpose=(None if g.transpose is None
                   else pad_bsda_chunks(g.transpose, multiple)),
    )


# ---------------- aggregation ----------------

DenseFn = Callable[..., torch.Tensor]  # (g, xc[, n_out]) -> out


def bsda_dense_plain(g: BsdaGraph, xc: torch.Tensor,
                     n_out: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the dense part (the CUDA kernel's
    reference): [n0, F] in xc's dtype,

        out[b] = ds[b] * sum_d A[b, d] @ (ss * xc)[src_chunk[b, d]].

    The chunk gather + einsum of _bsda_spmm_impl (elliptic_gnn_tpu
    kernels/bsda.py:442-479) with the Pallas kernel's rounding points
    (pallas_bsda.py:99-117): the scaled rhs is rounded to xc's dtype, the
    products accumulate in f32, ds scales the f32 sum, and the result is
    rounded to xc's dtype.

    With `n_out`, the rectangular form (bsda_dense_cuda's): g's chunks are
    a slice of destination chunks, src_chunk holds chunk ids of xc's rows
    (the whole row grid), g.src_scale covers xc's rows and g.dst_scale the
    slice's; the first n_out rows of the slice come out."""
    n0, f = xc.shape
    c, b = g.chunk, g.num_chunks
    rhs = xc
    if g.src_scale is not None:
        rhs = rhs * g.src_scale[:n0, None].to(xc.dtype)
    src_chunks = b if n_out is None else -(-n0 // c)
    pad = src_chunks * c - n0
    if pad < 0:
        raise ValueError(f"x has {n0} rows; the tables hold {b * c}")
    if n_out is not None and not 0 < n_out <= b * c:
        raise ValueError(f"{n_out} output rows; the tables hold {b * c}")
    if pad:
        rhs = torch.cat([rhs, rhs.new_zeros((pad, f))], dim=0)
    gathered = rhs.reshape(src_chunks, c, f)[g.src_chunk.long()].float()  # [B, D, C, F]
    out = torch.einsum("bdij,bdjf->bif", g.a.to(xc.dtype).float(), gathered)
    out = out.reshape(b * c, f)
    if g.dst_scale is not None:
        out = out * g.dst_scale[:, None]
    return out[:n0 if n_out is None else n_out].to(xc.dtype)


def bsda_forward(g: BsdaGraph, xc: torch.Tensor, dense: DenseFn,
                 n_out: Optional[int] = None) -> torch.Tensor:
    """Dense part through `dense` (kernel or plain version), then the spill
    added with one index-add on residual_rows — in place on the fresh dense
    output, in its dtype, as the JAX kernel path adds it
    (pallas_bsda.py:402-411). With `n_out` the rectangular form: a slice of
    destination chunks (its residual's rows the slice's own, its sources
    rows of xc) writes n_out rows."""
    out = dense(g, xc) if n_out is None else dense(g, xc, n_out)
    if g.residual is not None:
        spill = ell_weighted_sum(g.residual, xc)  # f32 [R, F], compact rows
        out.index_add_(0, g.residual_rows, spill.to(out.dtype))
    return out


class _TransposeVjp(torch.autograd.Function):
    """d(A @ x)/dx applied to ct is A^T @ ct: the same forward on the
    transpose tables (elliptic_gnn_tpu kernels/pallas_bsda.py:422-436)."""

    @staticmethod
    def forward(ctx, xc, g, dense):
        ctx.g_t = g.transpose
        ctx.dense = dense
        return bsda_forward(g, xc, dense)

    @staticmethod
    def backward(ctx, ct):
        return (bsda_forward(ctx.g_t, ct.contiguous(), ctx.dense), None, None)


def spmm_with(g: BsdaGraph, x: torch.Tensor, dense: DenseFn,
              compute_dtype=None) -> torch.Tensor:
    """out = A_w @ x in x's dtype, computed in `compute_dtype` (bf16 under
    amp); gradients through the transpose tables when present."""
    out_dtype = x.dtype
    xc = x.to(compute_dtype) if compute_dtype is not None else x
    xc = xc.contiguous()
    if g.transpose is not None:
        out = _TransposeVjp.apply(xc, g, dense)
    else:
        out = bsda_forward(g, xc, dense)
    return out.to(out_dtype)


def bsda_spmm(g: BsdaGraph, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch BSDA SpMM (dense part + spill). Without transpose
    tables, autograd differentiates the plain ops directly."""
    return spmm_with(g, x, bsda_dense_plain, compute_dtype)
