"""Closed-form backward of BSDA GAT attention (port of
elliptic_gnn_tpu/kernels/gat_bwd.py).

Per head, with i the destination, j the source, mu the edge multiplicity,
t_ij = a_src_j + a_dst_i, and the forward's softmax state (m_i, s_i):

    e_ij   = mu_ij * exp(lrelu(t_ij) - m_i)
    acc_i  = sum_j e_ij x_j          s_i = sum_j e_ij

Given the cotangents A_i = dL/d acc_i and S_i = dL/d s_i at fixed m:

    dx_j     = sum_i e_ij A_i
    dt_ij    = e_ij * lrelu'(t_ij) * (x_j . A_i + S_i)
    da_dst_i = sum_j dt_ij           da_src_j = sum_i dt_ij

The shift m is treated as a constant: everything downstream of (acc, s) is
invariant to it, so its own cotangent contributes nothing.

`dense_bwd_head` is the dense-block part of these sums, the plain version
of the one-sweep backward CUDA kernel (kernels/gat_cuda.py). `sweep_dst_head`
and `sweep_src_head` are the same sums as two sweeps, each over its own
tables (the destination sweep over g, the source sweep over g.transpose,
kernels/bsda.py::gat_block_transpose): the plain versions of the two-sweep
backward kernels, which take the destination-side cotangents from the grad
payload G2 that `grad_payload` builds. `attend_bwd` is the
whole vector-Jacobian product of bsda_gat.attend's output y = acc / s,
dense blocks and spill, for which A_i = g_i / s_i and
S_i = -(y_i . g_i) / s_i. The exponent is clamped at 0: for real edges
lrelu(t) <= m_i by construction, and masked or padded entries (mu = 0)
would otherwise give inf * 0 = NaN.
"""
from __future__ import annotations

import torch

from .bsda import BsdaGraph
from .segment import segment_sum


def _block_terms(mult, asrc_j, adst_i, m_i, slope: float):
    """(e, e * lrelu'(t)) over dense blocks [B, D, C, C]; asrc_j broadcasts
    along the destination axis, adst_i and m_i along the source axis."""
    t = asrc_j + adst_i
    lr = torch.where(t >= 0, t, t * slope)
    e = torch.exp((lr - m_i).clamp_max(0.0)) * mult
    return e, e * torch.where(t >= 0, 1.0, slope)


def dense_bwd_head(g: BsdaGraph, xp_h, asrc_h, adst_h, m_h, abar_h, sbar_h,
                   slope: float):
    """One head's dense-block gradients. xp_h, abar_h [N_pad, Ch]; asrc_h,
    adst_h, m_h, sbar_h [N_pad]. Returns (dxp [N_pad, Ch], dasrc [N_pad],
    dadst [N_pad])."""
    b, c = g.num_chunks, g.chunk
    ch = xp_h.shape[1]
    src = g.src_chunk.long()
    abar3 = abar_h.reshape(b, c, ch)

    e, e_sig = _block_terms(
        g.a.to(torch.float32), asrc_h.reshape(b, c)[src][:, :, None, :],
        adst_h.reshape(b, c)[:, None, :, None],
        m_h.reshape(b, c)[:, None, :, None], slope)           # [B, D, Ci, Cj]
    xp_g = xp_h.reshape(b, c, ch)[src]                        # [B, D, Cj, Ch]
    q = torch.einsum("bif,bdjf->bdij", abar3, xp_g)           # x_j . A_i
    dt = e_sig * (q + sbar_h.reshape(b, c)[:, None, :, None])

    dadst = dt.sum(dim=(1, 3)).reshape(-1)
    # source-side sums scatter at chunk granularity; (b, d) -> src_chunk ids
    # may repeat, the segment sum adds them
    flat = src.reshape(-1)
    dasrc = segment_sum(dt.sum(dim=2).reshape(-1, c), flat, b).reshape(-1)
    dxp_bd = torch.einsum("bdij,bif->bdjf", e, abar3)         # [B, D, Cj, Ch]
    dxp = segment_sum(dxp_bd.reshape(-1, c, ch), flat, b).reshape(-1, ch)
    return dxp, dasrc, dadst


def grad_payload(gbar: torch.Tensor, payload: torch.Tensor, out_k: torch.Tensor,
                 h: int, ch: int, normalized: bool) -> torch.Tensor:
    """G2 [N_pad, h*ch + 3h] = [ A_bar | S_bar | a_dst | m ], the
    destination-side rows of the two-sweep backward, always in the RAW
    gauge: A_bar and S_bar are the cotangents of (acc, s). `gbar` is the
    cotangent of the forward's output `out_k` = [ acc or val | m | s ]
    (its m columns are dropped), `payload` the forward's input. With
    `normalized` the forward wrote val = acc / s and gbar is the cotangent
    of (val, s): A_bar = gbar / s, S_bar = gbar_s - (gbar . val) / s. This is
    the one place where the gauge is changed; the sweeps only see raw rows."""
    hc = h * ch
    abar, sbar = gbar[:, :hc], gbar[:, hc + h: hc + 2 * h]
    if normalized:
        inv_s = 1.0 / out_k[:, hc + h: hc + 2 * h].clamp_min(1e-16)
        dot = (abar * out_k[:, :hc]).reshape(-1, h, ch).sum(dim=-1)
        sbar = sbar - dot * inv_s
        abar = (abar.reshape(-1, h, ch) * inv_s[..., None]).reshape(-1, hc)
    return torch.cat([abar, sbar, payload[:, hc + h: hc + 2 * h],
                      out_k[:, hc: hc + h]], dim=1)


def sweep_dst_head(g: BsdaGraph, xp_h, asrc_h, abar_h, sbar_h, adst_h, m_h,
                   slope: float) -> torch.Tensor:
    """One head of the destination sweep over the FORWARD tables g: own
    rows i carry (A_bar, S_bar, a_dst, m), streamed rows j carry (xp,
    a_src). Returns d a_dst [N_pad]."""
    b, c = g.num_chunks, g.chunk
    ch = xp_h.shape[1]
    src = g.src_chunk.long()
    _, e_sig = _block_terms(
        g.a.to(torch.float32), asrc_h.reshape(b, c)[src][:, :, None, :],
        adst_h.reshape(b, c)[:, None, :, None],
        m_h.reshape(b, c)[:, None, :, None], slope)           # [B, D, Ci, Cj]
    q = torch.einsum("bif,bdjf->bdij", abar_h.reshape(b, c, ch),
                     xp_h.reshape(b, c, ch)[src])
    dt = e_sig * (q + sbar_h.reshape(b, c)[:, None, :, None])
    return dt.sum(dim=(1, 3)).reshape(-1)


def sweep_src_head(g_t: BsdaGraph, xp_h, asrc_h, abar_h, sbar_h, adst_h, m_h,
                   slope: float):
    """One head of the source sweep over the TRANSPOSE tables g_t
    (a[J, slot, j, i]: row j = source j of chunk J, column i = destination
    i of chunk src_chunk[J, slot]; kernels/bsda.py::gat_block_transpose):
    own rows j carry (xp, a_src), streamed rows i carry (A_bar, S_bar,
    a_dst, m). Returns (d xp [N_pad, Ch], d a_src [N_pad])."""
    b, c = g_t.num_chunks, g_t.chunk
    ch = xp_h.shape[1]
    dst = g_t.src_chunk.long()                                # [B, DT] -> I
    abar_g = abar_h.reshape(b, c, ch)[dst]                    # [B, DT, Ci, Ch]
    e, e_sig = _block_terms(
        g_t.a.to(torch.float32), asrc_h.reshape(b, c)[:, None, :, None],
        adst_h.reshape(b, c)[dst][:, :, None, :],
        m_h.reshape(b, c)[dst][:, :, None, :], slope)         # [B, DT, Cj, Ci]
    q = torch.einsum("bdif,bjf->bdji", abar_g, xp_h.reshape(b, c, ch))
    dt = e_sig * (q + sbar_h.reshape(b, c)[dst][:, :, None, :])
    dxp = torch.einsum("bdji,bdif->bjf", e, abar_g).reshape(-1, ch)
    return dxp, dt.sum(dim=(1, 3)).reshape(-1)


def _spill_bwd(g: BsdaGraph, xp, asrc, adst, m, abar, sbar, slope,
               dxp, dasrc, dadst):
    """Residual-spill gradients, all heads, accumulated in place."""
    res = g.residual
    rows = g.residual_rows
    for nbr, w, rws in zip(res.nbrs, res.weights, res.rows):
        dst = rows[rws]                                # [R]
        t = asrc[nbr] + adst[dst][:, None, :]          # [R, W, H]
        lr = torch.where(t >= 0, t, t * slope)
        e = torch.exp((lr - m[dst][:, None, :]).clamp_max(0.0)) * w[:, :, None]
        q = torch.einsum("rhf,rwhf->rwh", abar[dst], xp[nbr])
        dt = e * torch.where(t >= 0, 1.0, slope) * (q + sbar[dst][:, None, :])
        dadst.index_add_(0, dst, dt.sum(dim=1))
        flat = nbr.reshape(-1)
        dasrc.index_add_(0, flat, dt.reshape(flat.shape[0], -1))
        dxp.index_add_(0, flat, (e[..., None] * abar[dst][:, None, :, :]).reshape(
            (flat.shape[0],) + tuple(xp.shape[1:])))
    return dxp, dasrc, dadst


def attend_bwd(g: BsdaGraph, slope: float, res, gbar):
    """Vector-Jacobian product of bsda_gat.attend's y: res = (xp, asrc,
    adst, m, s, y) on the padded arrays, gbar [N_pad, H, Ch] the cotangent
    of y. Returns (dxp, dasrc, dadst)."""
    xp, asrc, adst, m, s, y = res
    h = xp.shape[1]
    inv_s = 1.0 / s.clamp_min(1e-16)
    abar = gbar * inv_s[..., None]
    sbar = -(y * gbar).sum(dim=-1) * inv_s
    outs = [dense_bwd_head(g, xp[:, k, :], asrc[:, k], adst[:, k], m[:, k],
                           abar[:, k, :], sbar[:, k], slope) for k in range(h)]
    dxp = torch.stack([o[0] for o in outs], dim=1)        # [N_pad, H, Ch]
    dasrc = torch.stack([o[1] for o in outs], dim=1)      # [N_pad, H]
    dadst = torch.stack([o[2] for o in outs], dim=1)
    if g.residual is not None:
        dxp, dasrc, dadst = _spill_bwd(g, xp, asrc, adst, m, abar, sbar, slope,
                                       dxp, dasrc, dadst)
    return dxp, dasrc, dadst
