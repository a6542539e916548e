"""GSPMD row sharding: each rank computes its own destination rows from
every row of the graph (port of the GSPMD path of
elliptic_gnn_tpu/parallel/sharded.py, where XLA partitions the aggregation
by the row-sharded inputs and inserts the all-gathers itself).

Node rows are split into one contiguous block of n_loc rows per rank, as
on the halo path; nothing is assumed of the graph's band. Each aggregation
is one autograd rule:

  - BSDA (sage, gcn; RowShardedBsda): the forward all-gathers the node rows
    into the whole [n_rows, F] and runs this rank's destination chunks
    alone: the rectangular launch of the BSDA kernel
    (kernels/bsda_spmm_cuda.py, csrc/bsda_spmm.cu), which reads every row
    and writes n_loc, then the residual spill of this rank's rows. The
    backward all-gathers the output cotangent and runs the same launch on
    this rank's slice of the transpose tables, whose destination chunks
    are this rank's source rows: the rank's own d x, with no
    reduce-scatter.
  - GAT on a RowShardedBsda (row_gat_attend_packed, the model's route):
    the rank's packed payload rows [xp | a_src | a_dst] all-gathered, the
    rectangular launch of the GAT forward kernel on the rank's destination
    chunks (kernels/packed_gat.py, csrc/gat_fwd.cu), then the slice's
    spill. The backward is one of two: the one-sweep kernel's cotangent of
    every row, or with the two-sweep backward the destination sweep on the
    rank's chunks, its G2 rows all-gathered, and the source sweep on the
    rank's slice of the transpose tables for its own source rows (zero
    elsewhere). Either way the all-gather's reduce-scatter (SUM) takes the
    cotangent back to the rows' owners: it also carries the spill's, whose
    sources may be any rank's rows.
  - ELL (RowShardedEll), and the plain GAT attention (row_gat_attend: the
    CPU yardstick of the kernels' route, and GAT on the ELL encoding): the
    forward all-gathers the rows and runs the ELL gather, or the plain
    chunk-pair attention (kernels/bsda_gat.py) of this rank's destination
    chunks; autograd differentiates it, and the all-gather's backward is a
    reduce-scatter (SUM) of the whole rows' cotangent.

On CPU tensors the BSDA and GAT rules take the kernels' plain versions; on
CUDA tensors they launch the kernels or raise. The training step (BatchNorm
statistics, the loss and the gradients all-reduced) is the halo path's
(train/train_gnn.py::_sharded_step); the rank and its process group travel
with the encoding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.bsda import BsdaGraph, bsda_dense_plain, bsda_forward
from ..kernels.bsda_gat import attend
from ..kernels.ell import EllGraph, ell_gat_aggregate, ell_weighted_sum
from ..kernels.encoding import GraphEncoding


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def ell_select_rows(g: EllGraph, lo: int, hi: int) -> EllGraph:
    """Destination rows lo..hi - 1 of g as an EllGraph of hi - lo rows: the
    bucket rows that they own (in g's bucket order), `rows` counted from
    lo, the source ids g's own, and an inv_perm over the selection (None
    where the selection is in row order already, as a renumber_for_ell
    graph's is: no reorder gather). Bucket rows that no destination owns
    (the mesh padding of shard_ell_graph) are left out. On the CPU."""
    n = hi - lo
    inv = np.arange(g.num_nodes) if g.inv_perm is None else _np(g.inv_perm)
    pos = inv[lo:hi].astype(np.int64)
    sizes = [int(t.shape[0]) for t in g.nbrs]
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    local = np.empty(n, np.int64)
    nbrs, weights, rows, scales = [], [], [], []
    base = 0
    for k in range(len(sizes)):
        sel = np.nonzero((pos >= off[k]) & (pos < off[k + 1]))[0]
        sel = sel[np.argsort(pos[sel], kind="stable")]
        idx = pos[sel] - off[k]
        local[sel] = base + np.arange(sel.size)
        base += sel.size
        nbrs.append(torch.from_numpy(_np(g.nbrs[k])[idx]))
        weights.append(torch.from_numpy(_np(g.weights[k])[idx]))
        rows.append(torch.from_numpy(_np(g.rows[k])[idx] - lo))
        scales.append(torch.from_numpy(_np(g.row_scale[k])[idx]))
    zero = np.nonzero(pos >= off[-1])[0]
    local[zero] = base + np.arange(zero.size)
    in_order = bool(np.array_equal(local, np.arange(n)))
    return EllGraph(nbrs=tuple(nbrs), weights=tuple(weights), rows=tuple(rows),
                    inv_perm=None if in_order else torch.from_numpy(local),
                    row_scale=tuple(scales),
                    num_nodes=n, widths=g.widths, n_zero_deg=int(zero.size))


def bsda_row_slice(g: BsdaGraph, n_dev: int, rank: int) -> BsdaGraph:
    """Rank `rank`'s destination chunks of g (num_chunks a multiple of
    n_dev: kernels/bsda.py::pad_bsda_chunks) as a BsdaGraph of the
    rectangular form: a, the packed planes, src_chunk (ids of the whole
    grid's chunks), slot_occ and dst_scale cut to the slice; src_scale over
    every row; the residual spill of the slice's rows (sources the whole
    grid's rows, residual_rows counted from the slice's first row); no
    transpose."""
    if g.num_chunks % n_dev:
        raise ValueError(f"{g.num_chunks} chunks do not tile {n_dev} ranks; pad the "
                         "tables with kernels/bsda.py::pad_bsda_chunks")
    b_loc = g.num_chunks // n_dev
    c0, c1 = rank * b_loc, (rank + 1) * b_loc
    lo, hi = c0 * g.chunk, c1 * g.chunk

    def cut(t, a, b):
        return None if t is None else t[a:b].clone()

    residual = residual_rows = None
    if g.residual is not None:
        rr = _np(g.residual_rows)
        k0, k1 = (int(v) for v in np.searchsorted(rr, [lo, hi]))
        if k1 > k0:
            residual = ell_select_rows(g.residual, k0, k1)
            residual_rows = torch.from_numpy(rr[k0:k1] - lo)
    return dataclasses.replace(
        g, a=cut(g.a, c0, c1), a_packed=cut(g.a_packed, c0, c1),
        src_chunk=cut(g.src_chunk, c0, c1), slot_occ=cut(g.slot_occ, c0, c1),
        dst_scale=cut(g.dst_scale, lo, hi), residual=residual,
        residual_rows=residual_rows, num_nodes=hi - lo, num_chunks=b_loc, n_pad=0,
        transpose=None)


@dataclasses.dataclass
class RowShardedBsda(GraphEncoding):
    """One rank's BSDA encoding under the GSPMD row sharding: `fwd` the
    slice of destination chunks it owns (bsda_row_slice), `bwd` the same
    slice of the transpose tables (the aggregation's backward; for GAT the
    two-sweep backward's source sweep, None without it), `n_rows` the rows
    of the whole grid, the rank's place and its process `group` (None: the
    world)."""

    fwd: BsdaGraph
    bwd: Optional[BsdaGraph]
    n_dev: int
    n_rows: int
    rank: int
    group: Optional[dist.ProcessGroup] = None

    @property
    def n_loc(self) -> int:
        return self.n_rows // self.n_dev

    def to(self, device) -> "RowShardedBsda":
        """A copy with every table on `device`."""
        return dataclasses.replace(
            self, fwd=self.fwd.to(device),
            bwd=None if self.bwd is None else self.bwd.to(device))

    def spmm(self, x, compute_dtype=None):
        return row_bsda_spmm(self, x, compute_dtype=compute_dtype)

    def gat_attend(self, x_proj, alpha_src, alpha_dst, negative_slope=0.2):
        return row_gat_attend(self, x_proj, alpha_src, alpha_dst, negative_slope)

    def packed_gat_route(self):
        """This rank's rows (row_gat_attend_packed), on either device."""
        return self.n_loc, lambda p, h, ch, s: row_gat_attend_packed(self, p, h, ch, s)


@dataclasses.dataclass
class RowShardedEll(GraphEncoding):
    """One rank's ELL encoding under the GSPMD row sharding: `ell` the
    bucket rows of its n_loc destination rows (ell_select_rows), sources
    ids of the whole padded graph's rows."""

    ell: EllGraph
    n_dev: int
    n_rows: int
    rank: int
    group: Optional[dist.ProcessGroup] = None

    @property
    def n_loc(self) -> int:
        return self.n_rows // self.n_dev

    def to(self, device) -> "RowShardedEll":
        return dataclasses.replace(self, ell=self.ell.to(device))

    def spmm(self, x, compute_dtype=None):
        """The ELL gather of this rank's rows, at full precision (row_ell_spmm)."""
        return row_ell_spmm(self, x)

    def gat_attend(self, x_proj, alpha_src, alpha_dst, negative_slope=0.2):
        return row_gat_attend(self, x_proj, alpha_src, alpha_dst, negative_slope)


def row_sharded_bsda(g: BsdaGraph, n_dev: int, rank: int,
                     group: Optional[dist.ProcessGroup] = None) -> RowShardedBsda:
    """Rank `rank`'s RowShardedBsda of g (on the CPU), with the transpose
    tables' slice where g has them; their chunk grid must be g's, so that
    the rank's source rows are whole transpose chunks."""
    bwd = None
    if g.transpose is not None:
        if g.transpose.num_chunks != g.num_chunks or g.transpose.chunk != g.chunk:
            raise ValueError(f"the transpose tables' grid ({g.transpose.num_chunks} "
                             f"chunks) is not the forward's ({g.num_chunks})")
        bwd = bsda_row_slice(g.transpose, n_dev, rank)
    return RowShardedBsda(fwd=bsda_row_slice(g, n_dev, rank), bwd=bwd, n_dev=n_dev,
                          n_rows=g.num_chunks * g.chunk, rank=rank, group=group)


def row_sharded_ell(g: EllGraph, n_dev: int, rank: int,
                    group: Optional[dist.ProcessGroup] = None) -> RowShardedEll:
    """Rank `rank`'s RowShardedEll of a graph whose rows tile the ranks
    (shard_ell_graph's padding)."""
    if g.num_nodes % n_dev:
        raise ValueError(f"{g.num_nodes} rows do not tile {n_dev} ranks")
    n_loc = g.num_nodes // n_dev
    return RowShardedEll(ell=ell_select_rows(g, rank * n_loc, (rank + 1) * n_loc),
                         n_dev=n_dev, n_rows=g.num_nodes, rank=rank, group=group)


# ---------------- collectives ----------------

def all_gather_rows(rs, t: torch.Tensor) -> torch.Tensor:
    """Every rank's n_loc rows of t, in rank order: [n_rows, ...]. The
    collectives go by the name both torch releases the port meets have
    (all_gather_single where it exists, else all_gather_into_tensor)."""
    t = t.contiguous()
    out = t.new_empty((rs.n_rows,) + tuple(t.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=rs.group)
    return out


def reduce_scatter_rows(rs, t: torch.Tensor) -> torch.Tensor:
    """This rank's n_loc rows of the sum over ranks of t [n_rows, ...]."""
    t = t.contiguous()
    out = t.new_empty((rs.n_loc,) + tuple(t.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, t, group=rs.group)
    return out


class _AllGather(torch.autograd.Function):
    """all_gather_rows; its transpose is the reduce-scatter (SUM): each
    rank's whole-rows cotangent holds the part of its own loss share that
    flows back into every rank's rows."""

    @staticmethod
    def forward(ctx, t, rs):
        ctx.rs = rs
        return all_gather_rows(rs, t)

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter_rows(ctx.rs, ct), None


def gather_rows_diff(rs, t: torch.Tensor) -> torch.Tensor:
    """Differentiable all_gather_rows."""
    return _AllGather.apply(t, rs)


# ---------------- aggregations ----------------

class _RowBsdaAggregate(torch.autograd.Function):
    """This rank's rows of A @ x from its own rows of x: the all-gather,
    the rectangular dense part and the slice's spill; backward the
    all-gathered cotangent through the transpose slice (the rank's own
    source rows). `dense` is the kernel or, on CPU tensors, its plain
    version."""

    @staticmethod
    def forward(ctx, x_loc, rs, dense):
        ctx.rs, ctx.dense = rs, dense
        return bsda_forward(rs.fwd, all_gather_rows(rs, x_loc), dense, n_out=rs.n_loc)

    @staticmethod
    def backward(ctx, ct):
        rs = ctx.rs
        ct_all = all_gather_rows(rs, ct)
        return bsda_forward(rs.bwd, ct_all, ctx.dense, n_out=rs.n_loc), None, None


def row_bsda_spmm(rs: RowShardedBsda, x_local: torch.Tensor,
                  compute_dtype=None) -> torch.Tensor:
    """The GSPMD aggregation of this rank's rows x_local [n_loc, F]: [n_loc,
    F] in x_local's dtype, computed (and all-gathered) in `compute_dtype`
    (bf16 under amp)."""
    if rs.bwd is None and x_local.requires_grad and torch.is_grad_enabled():
        raise ValueError("gradients through the GSPMD BSDA aggregation need the "
                         "transpose tables (build with transpose=True)")
    from ..kernels.bsda_spmm_cuda import bsda_dense_cuda

    dense = bsda_dense_cuda if x_local.is_cuda else bsda_dense_plain
    xc = x_local.to(compute_dtype) if compute_dtype is not None else x_local
    return _RowBsdaAggregate.apply(xc.contiguous(), rs, dense).to(x_local.dtype)


def row_ell_spmm(rs: RowShardedEll, x_local: torch.Tensor) -> torch.Tensor:
    """The GSPMD ELL aggregation of this rank's rows, at full precision as
    the ELL path runs: the rows all-gathered, then the gather of the rank's
    destination rows."""
    return ell_weighted_sum(rs.ell, gather_rows_diff(rs, x_local)).to(x_local.dtype)


def row_gat_attend(rs, x_proj: torch.Tensor, alpha_src: torch.Tensor,
                   alpha_dst: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """GAT attention of this rank's rows in plain PyTorch: [x_proj | a_src]
    all-gathered (differentiably), then the chunk-pair attention of the
    rank's destination chunks (RowShardedBsda from 'gat' tables) or the
    ELL masked softmax of its rows (RowShardedEll). x_proj [n_loc, H, Ch],
    alpha_src/alpha_dst [n_loc, H]; returns [n_loc, H, Ch]."""
    n_loc, h, ch = x_proj.shape
    payload = torch.cat([x_proj.reshape(n_loc, h * ch).float(), alpha_src.float()], dim=1)
    every = gather_rows_diff(rs, payload)
    xp_all = every[:, : h * ch].reshape(-1, h, ch)
    asrc_all = every[:, h * ch:]
    if isinstance(rs, RowShardedEll):
        out = ell_gat_aggregate(rs.ell, xp_all, asrc_all, alpha_dst.float(),
                                negative_slope)
    else:
        out, _, _ = attend(rs.fwd, xp_all, asrc_all, alpha_dst.float(), negative_slope)
    return out.to(x_proj.dtype)


def row_gat_attend_packed(rs: RowShardedBsda, payload: torch.Tensor, h: int, ch: int,
                          negative_slope: float = 0.2) -> torch.Tensor:
    """This rank's rows [n_loc, W] of [ val | m | s ] through the GAT
    kernels, from its packed payload rows [n_loc, W] = [xp | a_src | a_dst]
    ('gat' tables): the rows all-gathered (differentiably), the rectangular
    forward of the rank's destination chunks (their first row rank *
    n_loc), the slice's spill merged. The backward's G2 rows are
    all-gathered for the source sweep on the rank's transpose slice."""
    from ..kernels.packed_gat import DenseTables, attend_rows

    row0 = rs.rank * rs.n_loc
    d = DenseTables(rs.fwd, dst_row0=row0, g_t=rs.bwd, t_row0=row0,
                    g2_rows=lambda g2: all_gather_rows(rs, g2))
    return attend_rows(d, gather_rows_diff(rs, payload), h, ch, negative_slope)
