"""Packed GAT pipeline: the whole stack through the flash kernels (port of
elliptic_gnn_tpu/kernels/packed_gat.py).

Per layer:

  1. projection and attention coefficients in ONE GEMM (torch.matmul, as
     the JAX package leaves it to XLA outside any kernel):
       payload = h_in @ [ W.reshape(F, H*Ch) | W a_src | W a_dst ]
     (a_src and a_dst are linear in the projected features, so they fold
     into the projection matrix), giving the kernels' packed rows
     [ xp | a_src | a_dst ] of width H*Ch + 2H;
  2. the forward kernel (kernels/gat_cuda.py) turns them into
     [ val = acc / s | m | s ], normalized in the kernel;
  3. the residual spill is merged on the few spill rows only, with a
     streaming-softmax merge of (m, s, acc) partials;
  4. bias and ELU on the val columns, which feed the next layer's GEMM.

The payload has no 128-lane padding (TPU tiling), so the next projection
needs no zero rows and the ELU never sees m or s.

Gradients: the kernel's forward and backward are tied in one
autograd.Function over the dense part; the spill merge, bias, ELU and
dropout are plain differentiable torch after it. The backward kernel
drops the cotangent of the m columns (the shift is a constant of the
backward: everything downstream of (acc, s) is invariant to it), and it
is told the gauge of its cotangent (val or raw acc) by the forward that
produced it, never by the caller of backward.

Two backwards give the same cotangent (kernels/gat_cuda.py): one sweep
with atomics, the default, or two sweeps without, bit-reproducible, which
need g.transpose. `use_two_sweep_backward` chooses; the trainer asks the
same function whether to build the transpose tables.

The same pipeline runs on a rank's share of a mesh run (packed_gat_route):
the halo path's shard over its halo-extended rows
(parallel/shardmap_step.py::sharded_gat_attend_packed) and the GSPMD row
sharding's rank over every row (parallel/gspmd_step.py::row_gat_attend_packed).
There the payload holds more rows than the kernels' grid: the grid's
destination chunks are a contiguous run of the payload's rows
(DenseTables.dst_row0), the kernels' rectangular launch, and autograd
returns the payload's cotangent over all its rows.

On CPU tensors the same pipeline runs through the kernels' plain versions.
Semantics match PyG GATConv: LeakyReLU(0.2) scores, per-destination
softmax over the self-looped edge multiset, ELU and concat between layers,
single-head final layer.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils.common import dropout as dropout_fn
from .bsda import BsdaGraph
from .bsda_gat import merge_partials, spill_partials
from .gat_cuda import gat_bwd, gat_bwd_two_sweep, gat_fwd


def use_two_sweep_backward() -> bool:
    """True when the GAT backward must be the bit-reproducible two-sweep
    pair: EGNN_GAT_ONE_SWEEP=0 (the JAX package's switch, same meaning), or
    torch.use_deterministic_algorithms(True), PyTorch's contract for an op
    whose default backward sums with atomics."""
    return (os.environ.get("EGNN_GAT_ONE_SWEEP", "1") == "0"
            or torch.are_deterministic_algorithms_enabled())


def _spill_gather_index(g: BsdaGraph):
    """Payload gather index for the spill merge (every spill neighbour id,
    then the spill destination node ids) and the segment sizes that slice
    the gather back apart. ONE gather: under autograd each separate gather
    of the payload would allocate its own full [N, W] gradient buffer."""
    res = g.residual
    rows = g.residual_rows  # compact spill row -> node id
    flat_parts = [nbr.reshape(-1) for nbr in res.nbrs]
    dst_parts = [rows[rws] for rws in res.rows]
    sizes = [int(p.shape[0]) for p in flat_parts]
    dsizes = [int(p.shape[0]) for p in dst_parts]
    return torch.cat(flat_parts + dst_parts), sizes, dsizes


def _spill_merge_rows(g: BsdaGraph, gathered: torch.Tensor, cur: torch.Tensor,
                      h: int, ch: int, negative_slope: float, sizes, dsizes,
                      normalized: bool) -> torch.Tensor:
    """From `gathered` [sum(sizes) + sum(dsizes), W] payload rows
    (neighbours, then destinations) and `cur` [R, W] kernel output on the
    spill rows, the spill attention partials merged into the kernel's:
    [R, W]. With `normalized`, cur's acc columns hold val = acc / s: raw
    partials are recovered as val * s and the merged rows normalized
    again. Compact [R]-space torch, differentiable."""
    res = g.residual
    hc = h * ch
    asrc_n, xp_n, adst_r = [], [], []
    off = 0
    for nbr, n in zip(res.nbrs, sizes):
        pay_n = gathered[off: off + n].reshape(tuple(nbr.shape) + (gathered.shape[1],))
        asrc_n.append(pay_n[..., hc: hc + h])                      # [R, W, H]
        xp_n.append(pay_n[..., :hc].reshape(tuple(nbr.shape) + (h, ch)))
        off += n
    for nd in dsizes:
        adst_r.append(gathered[off: off + nd, hc + h: hc + 2 * h])
        off += nd
    m2, s2, acc2 = spill_partials(res, asrc_n, adst_r, xp_n, negative_slope)

    m1 = cur[:, hc: hc + h]
    s1 = cur[:, hc + h: hc + 2 * h]
    acc1 = cur[:, :hc].reshape(-1, h, ch)
    if normalized:
        acc1 = acc1 * s1[..., None]
    big, s, acc = merge_partials(m1, s1, acc1, m2, s2, acc2)
    if normalized:
        acc = acc / s.clamp_min(1e-16)[..., None]
    return torch.cat([acc.reshape(-1, hc), big, s], dim=1)


def _spill_merge_packed(g: BsdaGraph, payload: torch.Tensor, out: torch.Tensor,
                        h: int, ch: int, negative_slope: float,
                        normalized: bool, dst_row0: int = 0) -> torch.Tensor:
    """Merge the residual-spill partials into the packed kernel output on
    the gathered spill rows only. `out` holds g's rows; on a run of them
    (`dst_row0`) the spill's destination ids count from the run's first row
    (payload row dst_row0) and its neighbour ids are payload rows."""
    if g.residual is None:
        return out
    rows = g.residual_rows
    idx, sizes, dsizes = _spill_gather_index(g)
    if dst_row0:
        n_nbr = sum(sizes)
        idx = torch.cat([idx[:n_nbr], idx[n_nbr:] + dst_row0])
    merged = _spill_merge_rows(g, payload[idx], out[rows], h, ch, negative_slope,
                               sizes, dsizes, normalized)
    return out.index_copy(0, rows, merged)


@dataclasses.dataclass
class DenseTables:
    """Where the dense part of one attention runs over a payload. `g`: the
    destination chunks' tables, whose first row is payload row `dst_row0`
    (0, and the payload's own rows, on one device; a rank's or a shard's
    run of rows on a mesh, its src_chunk ids indexing every payload row).
    For the two-sweep backward: `g_t`, the transpose tables, whose
    destination chunks are source rows of g's edges from payload row
    `t_row0` on (None: g.transpose), and `g2_rows`, which turns the
    destination sweep's G2 rows (g's grid) into the rows that g_t's ids
    index (None: they are those rows)."""

    g: BsdaGraph
    dst_row0: int = 0
    g_t: Optional[BsdaGraph] = None
    t_row0: int = 0
    g2_rows: Optional[Callable] = None


class _AttendDense(torch.autograd.Function):
    """The dense part of the attention through the forward kernel, with the
    backward kernel as its gradient, on DenseTables `d`. `normalized` is
    fixed by the forward and saved for the backward, so that a cotangent in
    the val gauge can never reach a backward in the raw gauge. The
    payload's cotangent covers every payload row: on a mesh the rows of
    other ranks or the halo too, where the sources of its edges lie."""

    @staticmethod
    def forward(ctx, payload, d, h, ch, negative_slope, normalized):
        out_k = gat_fwd(d.g, payload, h, ch, negative_slope, normalize=normalized,
                        dst_row0=d.dst_row0)
        ctx.save_for_backward(payload, out_k)
        ctx.meta = (d, h, ch, negative_slope, normalized)
        return out_k

    @staticmethod
    def backward(ctx, gbar):
        payload, out_k = ctx.saved_tensors
        d, h, ch, negative_slope, normalized = ctx.meta
        # two sweeps without transpose tables raise: no sliding back to the
        # one-sweep kernel
        if use_two_sweep_backward():
            ct = gat_bwd_two_sweep(d.g, gbar.contiguous(), payload, out_k, h, ch,
                                   negative_slope, normalized=normalized,
                                   dst_row0=d.dst_row0, g_t=d.g_t, t_row0=d.t_row0,
                                   g2_rows=d.g2_rows)
        else:
            ct = gat_bwd(d.g, gbar.contiguous(), payload, out_k, h, ch, negative_slope,
                         normalized=normalized, dst_row0=d.dst_row0)
        return ct, None, None, None, None, None


def attend_rows(d: DenseTables, payload: torch.Tensor, h: int, ch: int,
                negative_slope: float) -> torch.Tensor:
    """[ val | m | s ] rows of d.g's destinations: the forward kernel
    (normalized in the kernel) plus the spill merge. Differentiable with
    respect to the payload; only the val columns may feed a loss (m and s
    are gauges)."""
    out_k = _AttendDense.apply(payload, d, h, ch, negative_slope, True)
    return _spill_merge_packed(d.g, payload, out_k, h, ch, negative_slope,
                               normalized=True, dst_row0=d.dst_row0)


def _attend_packed(g: BsdaGraph, payload: torch.Tensor, h: int, ch: int,
                   negative_slope: float) -> torch.Tensor:
    """attend_rows of the whole graph: payload [N_pad, W] -> [N_pad, W]."""
    return attend_rows(DenseTables(g), payload, h, ch, negative_slope)


def packed_gat_route(g):
    """(rows, attend) of an encoding whose GAT runs packed: the rows of the
    payload a layer computes here and attend(payload, h, ch, slope) ->
    [ val | m | s ] of those rows; None for an encoding that attends
    otherwise (EllGraph, RowShardedEll). A BsdaGraph: the whole graph; a
    ShardedBsda: this rank's shard of the halo path; a RowShardedBsda: this
    rank's rows of the GSPMD row sharding."""
    if isinstance(g, BsdaGraph):
        return g.num_chunks * g.chunk, lambda p, h, ch, s: _attend_packed(g, p, h, ch, s)
    from ..parallel import gspmd_step, shardmap_step

    if isinstance(g, gspmd_step.RowShardedBsda):
        return g.n_loc, lambda p, h, ch, s: gspmd_step.row_gat_attend_packed(g, p, h, ch, s)
    if isinstance(g, shardmap_step.ShardedBsda):
        return (g.a.shape[1] * g.chunk,
                lambda p, h, ch, s: shardmap_step.sharded_gat_attend_packed(g, p, h, ch, s))
    return None


def _projection(p: dict) -> torch.Tensor:
    """[F, H*Ch + 2H] = [ W | W a_src | W a_dst ] of one layer."""
    w = p["w"].float()
    f_in, h, ch = w.shape
    return torch.cat([w.reshape(f_in, h * ch),
                      torch.einsum("fhc,hc->fh", w, p["a_src"].float()),
                      torch.einsum("fhc,hc->fh", w, p["a_dst"].float())], dim=1)


def packed_gat_train_forward(layer_params: Sequence[dict], x: torch.Tensor,
                             g: BsdaGraph, dropout: float = 0.0,
                             generator: Optional[torch.Generator] = None,
                             negative_slope: float = 0.2) -> torch.Tensor:
    """Differentiable forward of the whole GAT stack in packed form.

    layer_params: list of {"w" [F,H,Ch], "a_src" [H,Ch], "a_dst" [H,Ch],
    "b" [out]}; hidden layers concat heads, the final layer is single-head.
    x [N, F] node features. `dropout` > 0 drops hidden activations with
    masks drawn from `generator`. Returns logits [N, num_classes]. `g` is a
    BsdaGraph, or a rank's share of a mesh run (packed_gat_route): then x
    holds the rank's rows."""
    if layer_params[-1]["w"].shape[1] != 1:
        raise ValueError("the final GAT layer must be single-head")
    route = packed_gat_route(g)
    if route is None:
        raise TypeError(f"the packed GAT pipeline does not run on {type(g).__name__}")
    n_pad, attend = route
    n0 = x.shape[0]
    if n0 > n_pad:
        raise ValueError(f"x has {n0} rows; the tables hold {n_pad}")
    h_in = x.float()
    if n0 < n_pad:
        h_in = torch.cat([h_in, h_in.new_zeros((n_pad - n0, x.shape[1]))], dim=0)

    for li, p in enumerate(layer_params):
        _, h, ch = p["w"].shape
        hc = h * ch
        payload = h_in @ _projection(p)  # [n_pad, hc + 2h]
        val = attend(payload, h, ch, negative_slope)[:, :hc]
        if li == len(layer_params) - 1:
            return (val + p["b"])[:n0]
        h_in = dropout_fn(F.elu(val + p["b"]), dropout, dropout > 0.0, generator)
    raise ValueError("layer_params is empty")


def packed_gat_forward(layer_params: Sequence[dict], x: torch.Tensor,
                       g: BsdaGraph, negative_slope: float = 0.2) -> torch.Tensor:
    """Forward-only packed GAT stack (inference and the per-epoch val
    eval): the same pipeline with no dropout and no graph recorded."""
    with torch.no_grad():
        return packed_gat_train_forward(layer_params, x, g,
                                        negative_slope=negative_slope)
