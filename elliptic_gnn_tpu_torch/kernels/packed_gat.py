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

On CPU tensors the same pipeline runs through the kernels' plain versions.
Semantics match PyG GATConv: LeakyReLU(0.2) scores, per-destination
softmax over the self-looped edge multiset, ELU and concat between layers,
single-head final layer.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

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
        pay_n = gathered[off: off + n].reshape(tuple(nbr.shape) + (-1,))
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
                        normalized: bool) -> torch.Tensor:
    """Merge the residual-spill partials into the packed kernel output on
    the gathered spill rows only."""
    if g.residual is None:
        return out
    rows = g.residual_rows
    idx, sizes, dsizes = _spill_gather_index(g)
    merged = _spill_merge_rows(g, payload[idx], out[rows], h, ch, negative_slope,
                               sizes, dsizes, normalized)
    return out.index_copy(0, rows, merged)


class _AttendDense(torch.autograd.Function):
    """The dense part of the attention through the forward kernel, with the
    backward kernel as its gradient. `normalized` is fixed by the forward
    and saved for the backward, so that a cotangent in the val gauge can
    never reach a backward in the raw gauge."""

    @staticmethod
    def forward(ctx, payload, g, h, ch, negative_slope, normalized):
        out_k = gat_fwd(g, payload, h, ch, negative_slope, normalize=normalized)
        ctx.save_for_backward(payload, out_k)
        ctx.meta = (g, h, ch, negative_slope, normalized)
        return out_k

    @staticmethod
    def backward(ctx, gbar):
        payload, out_k = ctx.saved_tensors
        g, h, ch, negative_slope, normalized = ctx.meta
        # two sweeps without transpose tables raise: no sliding back to the
        # one-sweep kernel
        bwd = gat_bwd_two_sweep if use_two_sweep_backward() else gat_bwd
        ct = bwd(g, gbar.contiguous(), payload, out_k, h, ch, negative_slope,
                 normalized=normalized)
        return ct, None, None, None, None, None


def _attend_packed(g: BsdaGraph, payload: torch.Tensor, h: int, ch: int,
                   negative_slope: float) -> torch.Tensor:
    """[ val | m | s ] rows of the whole attention: kernel (normalized in
    the kernel) plus spill merge. Differentiable with respect to the
    payload; only the val columns may feed a loss (m and s are gauges)."""
    out_k = _AttendDense.apply(payload, g, h, ch, negative_slope, True)
    return _spill_merge_packed(g, payload, out_k, h, ch, negative_slope,
                               normalized=True)


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
    masks drawn from `generator`. Returns logits [N, num_classes]."""
    if layer_params[-1]["w"].shape[1] != 1:
        raise ValueError("the final GAT layer must be single-head")
    n0 = x.shape[0]
    n_pad = g.num_chunks * g.chunk
    if n0 > n_pad:
        raise ValueError(f"x has {n0} rows; the tables hold {n_pad}")
    h_in = x.float()
    if n0 < n_pad:
        h_in = torch.cat([h_in, h_in.new_zeros((n_pad - n0, x.shape[1]))], dim=0)

    for li, p in enumerate(layer_params):
        _, h, ch = p["w"].shape
        hc = h * ch
        payload = h_in @ _projection(p)  # [n_pad, hc + 2h]
        val = _attend_packed(g, payload, h, ch, negative_slope)[:, :hc]
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
