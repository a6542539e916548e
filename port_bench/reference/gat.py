"""Plain reference of GAT (arch gat), as PyG's GATConv computes it: per
layer a projection to `heads` heads of hidden // heads features, scores
LeakyReLU_0.2(a_src . xp[src] + a_dst . xp[dst]) over the in-edges with a
self-loop added to every node (a multiset: a repeated edge counts each
time), a softmax over each destination's edges, the weighted sum of the
sources' features, heads concatenated plus a bias; ELU and dropout between
layers; the last layer one head of two features, averaged over its head.
All in f32, as the configuration states for GAT whatever `amp` says.

The program draws GAT's dropout masks over its packed rows on the card:
the node rows padded to whole chunks of 128.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import workcount as W
from .common import CHUNK


def _heads(cfg: dict):
    hidden, layers, heads = int(cfg["hidden_dim"]), int(cfg["layers"]), int(cfg["heads"])
    return hidden // heads, layers, heads


def param_spec(cfg: dict, in_dim: int) -> list:
    d_head, layers, heads = _heads(cfg)
    dims = [in_dim] + [heads * d_head] * (layers - 1)
    spec = []
    for i in range(layers):
        h, c = (heads, d_head) if i < layers - 1 else (1, 2)
        spec += [(f"layers.{i}.w", (dims[i], h, c), ("glorot", dims[i], h * c)),
                 (f"layers.{i}.a_src", (h, c), ("glorot", c, 1)),
                 (f"layers.{i}.a_dst", (h, c), ("glorot", c, 1)),
                 (f"layers.{i}.b", (h * c if i < layers - 1 else c,), ("zeros",))]
    return spec


def mask_layout(cfg: dict, n: int, device_type: str):
    d_head, layers, heads = _heads(cfg)
    rows = -(-n // CHUNK) * CHUNK if device_type == "cuda" else n
    return rows, heads * d_head, layers - 1


class Model:
    def __init__(self, cfg: dict, graph, precision):
        self.cfg, self.g, self.p = cfg, graph, precision
        _, self.layers, _ = _heads(cfg)
        loops = torch.arange(graph.n, device=graph.src.device)
        self.src = torch.cat([graph.src, loops])
        self.dst = torch.cat([graph.dst, loops])
        self.dropout = float(cfg.get("dropout", 0.0))

    def buffers(self) -> dict:
        """GAT keeps no running statistics."""
        return {}

    def _attend(self, h, w, a_src, a_dst, b, concat):
        n, (f_in, heads, ch) = h.shape[0], w.shape
        xp = self.p.mm(h, w.reshape(f_in, heads * ch)).view(n, heads, ch)
        al_s = (xp * a_src).sum(-1)
        al_d = (xp * a_dst).sum(-1)
        e = F.leaky_relu(al_s[self.src] + al_d[self.dst], 0.2)
        with torch.no_grad():  # the softmax's shift: a constant of its gradient
            m = torch.full((n, heads), -torch.inf, device=h.device).scatter_reduce(
                0, self.dst[:, None].expand(-1, heads), e, "amax", include_self=True)
        ex = torch.exp(e - m[self.dst])
        s = torch.zeros((n, heads), device=h.device).index_add(0, self.dst, ex)
        acc = torch.zeros((n, heads, ch), device=h.device).index_add(
            0, self.dst, ex[..., None] * xp[self.src])
        out = acc / s[..., None]
        out = out.reshape(n, heads * ch) if concat else out.mean(dim=1)
        return out + b

    def forward(self, P: dict, training: bool, masks=None) -> torch.Tensor:
        keep = 1.0 - self.dropout
        h = self.g.x
        for i in range(self.layers):
            last = i == self.layers - 1
            h = self._attend(h, P[f"layers.{i}.w"], P[f"layers.{i}.a_src"],
                             P[f"layers.{i}.a_dst"], P[f"layers.{i}.b"], not last)
            if last:
                return h
            h = F.elu(h)
            if training and self.dropout > 0:
                h = torch.where(masks[i][self.g.rank_t], h / keep, torch.zeros((), device=h.device))
        raise ValueError("no layers")


def epoch_work(cfg: dict, n: int, edges: int, in_dim: int) -> list:
    """'dense' projections, 'attn_fwd' and 'attn_bwd' attentions of one
    epoch; `edges` without the self-loops."""
    d_head, layers, heads = _heads(cfg)
    mm_prec = "bf16" if bool(cfg.get("amp", False)) else "f32"
    e_sl = edges + n
    dims = [in_dim] + [heads * d_head] * (layers - 1)
    fwd, att, bwd = [], [], []
    for i in range(layers):
        h, c = (heads, d_head) if i < layers - 1 else (1, 2)
        fwd.append(W.dense("dense", n, dims[i], h * c + 2 * h, mm_prec))
        att.append(W.attention_fwd("attn_fwd", n, e_sl, h, c))
        bwd.append(W.attention_bwd("attn_bwd", n, e_sl, h, c))
    return fwd * 4 + att * 2 + bwd
