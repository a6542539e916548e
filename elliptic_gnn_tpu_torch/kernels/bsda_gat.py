"""BSDA GAT attention, plain PyTorch formulation (port of
elliptic_gnn_tpu/kernels/bsda_gat.py).

Per destination chunk b and slot d, attention scores form a dense C x C
block

    score[b,d,i,j] = LeakyReLU(a_src[src_j] + a_dst[dst_i])

masked by the block's edge-multiplicity pattern (parallel edges contribute
`mult` identical softmax terms, PyG's semantics for duplicate edges). The
per-destination softmax spans the D dense blocks and the spill residual;
the two parts combine with a streaming-softmax merge of (max, sumexp,
weighted-sum) triples, so the result is the global segment softmax.

In the port this is the reference: autograd through bsda_gat_aggregate
gives the reference gradients, and `dense_part` is the plain version of
the forward CUDA kernel (kernels/gat_cuda.py). It materializes
[B, D, C, C] tensors per head and is meant for tests and the CPU path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .bsda import BsdaGraph

NEG_INF = -1e30


def dense_part(g: BsdaGraph, xp_h: torch.Tensor, asrc_h: torch.Tensor,
               adst_h: torch.Tensor, negative_slope: float):
    """One head's dense-block attention partials.

    xp_h [N_pad, Ch], asrc_h/adst_h [N_pad] (padded to the chunk grid).
    Rectangular where g's chunks are a slice of destination chunks: xp_h
    and asrc_h then hold every row (src_chunk's ids index them), adst_h the
    slice's rows. Returns (m [B,C], s [B,C], acc [B,C,Ch]): the row max of the scores
    over the row's dense edges (NEG_INF for a row with none), the sum of
    exp(score - m) weighted by multiplicity, and the weighted feature sum."""
    b, c = g.num_chunks, g.chunk
    mult = g.a.to(torch.float32)  # [B, D, C, C] edge multiplicities
    src = g.src_chunk.long()
    asrc_chunks = asrc_h.reshape(-1, c)[src]  # [B, D, C]
    adst3 = adst_h.reshape(b, c)
    scores = torch.where(
        mult > 0,
        F.leaky_relu(asrc_chunks[:, :, None, :] + adst3[:, None, :, None],
                     negative_slope),
        asrc_h.new_full((), NEG_INF),
    )
    m = scores.amax(dim=(1, 3))  # [B, C]
    e = torch.exp(scores - m[:, None, :, None]) * mult
    xp_chunks = xp_h.reshape(-1, c, xp_h.shape[-1])[src]  # [B, D, C, Ch]
    # ones column: one product gives the weighted feature sum and the
    # softmax denominator
    xp_ext = torch.cat([xp_chunks, xp_chunks.new_ones(xp_chunks.shape[:-1] + (1,))],
                       dim=-1)
    acc_ext = torch.einsum("bdij,bdjf->bif", e, xp_ext)
    return m, acc_ext[..., -1], acc_ext[..., :-1]


def spill_partials(res, asrc_n, adst_r, xp_n, negative_slope: float):
    """Attention partials of the residual spill over its compact rows, all
    heads. Per ELL bucket k: asrc_n[k] [R_k, W_k, H] and xp_n[k]
    [R_k, W_k, H, Ch] are the neighbours' coefficients and features,
    adst_r[k] [R_k, H] the destinations' coefficients. Returns (m2 [R, H],
    s2 [R, H], acc2 [R, H, Ch]) in compact row order (every compact row
    has a spill edge, so the ELL has no zero-degree rows)."""
    m_parts, s_parts, acc_parts = [], [], []
    for a_n, a_r, x_n, w in zip(asrc_n, adst_r, xp_n, res.weights):
        sc = F.leaky_relu(a_n + a_r[:, None, :], negative_slope)  # [R, W, H]
        sc = torch.where((w > 0)[:, :, None], sc, sc.new_full((), NEG_INF))
        m_l = sc.amax(dim=1)
        e = torch.exp(sc - m_l[:, None, :]) * w[:, :, None]  # w = multiplicity
        m_parts.append(m_l)
        s_parts.append(e.sum(dim=1))
        acc_parts.append(torch.einsum("rwh,rwhf->rhf", e, x_n))
    m2 = torch.cat(m_parts)
    s2 = torch.cat(s_parts)
    acc2 = torch.cat(acc_parts)
    if res.inv_perm is not None:
        m2, s2, acc2 = m2[res.inv_perm], s2[res.inv_perm], acc2[res.inv_perm]
    return m2, s2, acc2


def _spill_part(g: BsdaGraph, xp, asrc, adst, negative_slope):
    """xp [N_pad, H, Ch], asrc/adst [N_pad, H] -> spill partials."""
    res, rows = g.residual, g.residual_rows
    return spill_partials(
        res, [asrc[nbr] for nbr in res.nbrs],
        [adst[rows[rws]] for rws in res.rows], [xp[nbr] for nbr in res.nbrs],
        negative_slope)


def merge_partials(m1, s1, acc1, m2, s2, acc2):
    """Streaming-softmax merge of two (m [., H], s [., H], acc [., H, Ch])
    partials. NEG_INF (finite) marks an empty partial, so the difference of
    two empty maxima is 0 and not NaN."""
    big = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - big)
    w2 = torch.exp(m2 - big)
    return big, s1 * w1 + s2 * w2, acc1 * w1[..., None] + acc2 * w2[..., None]


def attend(g: BsdaGraph, xp, asrc, adst, negative_slope: float):
    """Global segment-softmax attention on padded arrays: xp
    [N_pad, H, Ch], asrc/adst [N_pad, H] (N_pad = num_chunks * chunk).
    Returns (y [N_pad, H, Ch], m, s [N_pad, H]): the output and the merged
    softmax state. On a slice of destination chunks (dense_part's
    rectangular form; its residual's rows the slice's own) adst and the
    results have the slice's rows."""
    n_pad = adst.shape[0]
    h, ch = xp.shape[1:]
    parts = [dense_part(g, xp[:, k, :], asrc[:, k], adst[:, k], negative_slope)
             for k in range(h)]
    m = torch.stack([p[0].reshape(-1) for p in parts], dim=1)      # [N_pad, H]
    s = torch.stack([p[1].reshape(-1) for p in parts], dim=1)
    acc = torch.stack([p[2].reshape(-1, ch) for p in parts], dim=1)

    if g.residual is not None:
        m2c, s2c, acc2c = _spill_part(g, xp, asrc, adst, negative_slope)
        rows = g.residual_rows
        m2 = m.new_full((n_pad, h), NEG_INF).index_copy(0, rows, m2c)
        s2 = s.new_zeros((n_pad, h)).index_copy(0, rows, s2c)
        acc2 = acc.new_zeros((n_pad, h, ch)).index_copy(0, rows, acc2c)
        m, s, acc = merge_partials(m, s, acc, m2, s2, acc2)

    return acc / s.clamp_min(1e-16)[..., None], m, s


def pad_to_chunks(g: BsdaGraph, v: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Rows appended up to num_chunks * chunk, filled with `fill`."""
    n_pad = g.num_chunks * g.chunk - v.shape[0]
    if n_pad < 0:
        raise ValueError(f"{v.shape[0]} rows; the tables hold {g.num_chunks * g.chunk}")
    if n_pad == 0:
        return v
    return torch.cat([v, v.new_full((n_pad,) + tuple(v.shape[1:]), fill)], dim=0)


def bsda_gat_aggregate(g: BsdaGraph, x_proj: torch.Tensor,
                       alpha_src: torch.Tensor, alpha_dst: torch.Tensor,
                       negative_slope: float = 0.2) -> torch.Tensor:
    """Per-destination softmax-weighted neighbour sum, all heads:
    x_proj [N, H, Ch], alpha_src/alpha_dst [N, H] -> [N, H, Ch].

    `g` must come from build_bsda_for_kind(..., 'gat') (self-looped edges,
    unit weights), so that `a` holds edge multiplicities. Differentiable by
    autograd."""
    n0 = x_proj.shape[0]
    y, _, _ = attend(g, pad_to_chunks(g, x_proj),
                     pad_to_chunks(g, alpha_src, NEG_INF),
                     pad_to_chunks(g, alpha_dst, NEG_INF), negative_slope)
    return y[:n0]
