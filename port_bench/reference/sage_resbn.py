"""Plain reference of the SAGE-ResBN family (arch sage_resbn): per hidden
layer a SAGE convolution (mean of the in-neighbours through lin_l with a
bias, plus lin_r of the node itself), BatchNorm over all rows, ReLU,
dropout and a residual (identity, or a projection where the width
changes); the last convolution gives the two logits. A sinusoid of the
timestep (time_embed_dim features) is appended to the input.

Precision as the configuration states it: dense products in f32; with
`amp` the mean aggregation takes bf16 operands, sums in f32 and gives a
bf16 result. Forward, the operands are the features and the edges' counts
and 1/degree scales the f32 sum; backward, the transposed product's
operand is the bf16 cotangent times 1/degree in bf16. `aggregation: ell`
aggregates in f32.
"""
from __future__ import annotations

import math

import torch

from .. import workcount as W


def _dims(cfg: dict, in_dim: int):
    hidden, layers = int(cfg["hidden_dim"]), int(cfg["layers"])
    eff_in = in_dim + int(cfg.get("time_embed_dim", 0) or 0)
    return eff_in, hidden, layers


def param_spec(cfg: dict, in_dim: int) -> list:
    """(name, shape, init) of every parameter; init is ("glorot", fan_in,
    fan_out), ("zeros",) or ("ones",)."""
    eff_in, hidden, layers = _dims(cfg, in_dim)
    dims = [eff_in] + [hidden] * (layers - 1) + [2]
    spec = []
    for i in range(layers):
        d_in, d_out = dims[i], dims[i + 1]
        spec += [(f"layers.{i}.lin_l.weight", (d_out, d_in), ("glorot", d_in, d_out)),
                 (f"layers.{i}.lin_l.bias", (d_out,), ("zeros",)),
                 (f"layers.{i}.lin_r.weight", (d_out, d_in), ("glorot", d_in, d_out))]
    for i in range(layers - 1):
        spec += [(f"bns.{i}.scale", (hidden,), ("ones",)),
                 (f"bns.{i}.bias", (hidden,), ("zeros",))]
    for i in range(layers - 1):
        if dims[i] != hidden:
            spec.append((f"res_projs.{i}.weight", (hidden, dims[i]), ("glorot", dims[i], hidden)))
    return spec


def mask_layout(cfg: dict, n: int, device_type: str):
    """(rows, width, draws an epoch) of the program's dropout masks."""
    return n, int(cfg["hidden_dim"]), int(cfg["layers"]) - 1


def time_embed(t: torch.Tensor, dim: int, max_t: int) -> torch.Tensor:
    tt = torch.clamp(t.to(torch.float32) - 1.0, 0.0, float(max_t - 1)) / max(float(max_t - 1), 1.0)
    half = dim // 2
    freqs = torch.arange(1, half + 1, dtype=torch.float32, device=t.device) * (2.0 * math.pi)
    ang = tt[:, None] * freqs[None, :]
    feat = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if feat.shape[1] < dim:
        feat = torch.cat([feat, feat.new_zeros((feat.shape[0], dim - feat.shape[1]))], dim=1)
    return feat


class _MeanAgg(torch.autograd.Function):
    """out[d] = mean of x over d's in-edges (a multiset), with the operands
    and the result rounded as `prec` says (common.Precision)."""

    @staticmethod
    def forward(ctx, x, src, dst, inv_deg, prec):
        out = torch.zeros_like(x).index_add_(0, dst, prec.agg_operand(x)[src]) * inv_deg[:, None]
        ctx.save_for_backward(src, dst, inv_deg)
        ctx.prec = prec
        return prec.agg_result(out)

    @staticmethod
    def backward(ctx, g):
        src, dst, inv_deg = ctx.saved_tensors
        p = ctx.prec
        rhs = p.agg_operand(p.agg_result(g) * p.agg_result(inv_deg)[:, None])
        return p.agg_result(torch.zeros_like(g).index_add_(0, src, rhs[dst])), None, None, None, None


BN_MOMENTUM = 0.1  # the share of a training forward's statistics a step takes


class Model:
    """The forward of one configuration over a reference Graph. BatchNorm's
    running statistics live here and move in training forwards."""

    def __init__(self, cfg: dict, graph, precision):
        self.cfg, self.g, self.p = cfg, graph, precision
        _, hidden, layers = _dims(cfg, graph.x.shape[1])
        self.layers, self.hidden = layers, hidden
        dev = graph.x.device
        deg = torch.bincount(graph.dst, minlength=graph.n).to(torch.float32)
        self.inv_deg = 1.0 / torch.clamp(deg, min=1.0)
        dim = int(cfg.get("time_embed_dim", 0) or 0)
        x = graph.x
        if dim > 0:
            x = torch.cat([x, time_embed(graph.t, dim, int(cfg.get("max_timestep", 49)))], dim=1)
        self.x_in = x
        self.bn_mean = [torch.zeros(hidden, device=dev) for _ in range(layers - 1)]
        self.bn_var = [torch.ones(hidden, device=dev) for _ in range(layers - 1)]
        self.dropout = float(cfg.get("dropout", 0.0))
        self.bn_updates = 0

    def buffers(self) -> dict:
        """{name: (running statistic, what is left in it of its initial
        value)}, named as the program's model names its BatchNorm buffers."""
        left = (1.0 - BN_MOMENTUM) ** (self.bn_updates // max(self.layers - 1, 1))
        out = {}
        for i, (mean, var) in enumerate(zip(self.bn_mean, self.bn_var)):
            out[f"bns.{i}.mean"] = (mean.detach().cpu().clone(), 0.0)
            out[f"bns.{i}.var"] = (var.detach().cpu().clone(), left)
        return out

    def _lin(self, h, w, b=None):
        out = self.p.mm(h, w.t())
        return out if b is None else out + b

    def _bn(self, h, i, scale, bias, training):
        if training:
            n = float(h.shape[0])
            mean = h.sum(0) / n
            var = torch.clamp((h * h).sum(0) / n - mean * mean, min=0.0)
            with torch.no_grad():
                self.bn_updates += 1
                keep = 1.0 - BN_MOMENTUM
                self.bn_mean[i].mul_(keep).add_(BN_MOMENTUM * mean)
                self.bn_var[i].mul_(keep).add_(BN_MOMENTUM * var * n / max(n - 1.0, 1.0))
        else:
            mean, var = self.bn_mean[i], self.bn_var[i]
        return (h - mean) * torch.rsqrt(var + 1e-5) * scale + bias

    def forward(self, P: dict, training: bool, masks=None) -> torch.Tensor:
        g = self.g
        keep = 1.0 - self.dropout
        h = self.x_in
        for i in range(self.layers):
            agg = _MeanAgg.apply(h, g.src, g.dst, self.inv_deg, self.p)
            out = self._lin(agg, P[f"layers.{i}.lin_l.weight"], P[f"layers.{i}.lin_l.bias"]) \
                + self._lin(h, P[f"layers.{i}.lin_r.weight"])
            if i == self.layers - 1:
                return out
            out = torch.relu(self._bn(out, i, P[f"bns.{i}.scale"], P[f"bns.{i}.bias"], training))
            if training and self.dropout > 0:
                out = torch.where(masks[i][g.rank_t], out / keep, torch.zeros((), device=out.device))
            proj = P.get(f"res_projs.{i}.weight")
            h = out + (h if proj is None else self._lin(h, proj))
        raise ValueError("no layers")


def epoch_work(cfg: dict, n: int, edges: int, in_dim: int) -> list:
    """The work of one epoch (training forward, backward, eval forward):
    'dense' products and 'spmm' aggregations. `edges` counts the edges the
    aggregation runs over."""
    eff_in, hidden, layers = _dims(cfg, in_dim)
    dims = [eff_in] + [hidden] * (layers - 1) + [2]
    amp = bool(cfg.get("amp", False))
    mm_prec = "bf16" if amp else "f32"
    agg_elem = "bf16" if amp and str(cfg.get("aggregation", "auto")) != "ell" else "f32"
    fwd = []
    for i in range(layers):
        fwd += [W.dense("dense", n, dims[i], dims[i + 1], mm_prec)] * 2
        if i < layers - 1 and dims[i] != hidden:
            fwd.append(W.dense("dense", n, dims[i], hidden, mm_prec))
    aggs = [W.spmm("spmm", n, edges, dims[i], agg_elem, True) for i in range(layers)]
    # training: forward, then the backward's two products a forward
    # product (input and weight cotangents); the aggregation's backward
    # runs for every layer whose input has a gradient (not the features)
    return fwd * 4 + aggs * 2 + aggs[1:]
