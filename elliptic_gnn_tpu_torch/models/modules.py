"""GCN, SAGE, the SAGE-ResBN family and GAT as nn.Modules (port of
elliptic_gnn_tpu/models/modules.py).

    model = build_model("sage_resbn", in_dim, cfg, generator=gen)
    logits = model(x, g, t_idx, generator=dropout_gen)

Train/eval mode is the module's own flag (model.train()/model.eval()):
BatchNorm updates its running statistics in training mode, in place.
Parameters keep the JAX model's semantics — SAGEConv as lin_l(mean agg) +
lin_r(x), BatchNorm with torch-convention running stats and the JAX
formula for the batch variance, residual identity or linear projection, and
the exact sinusoid (or learned) time embedding. GCN is spmm(g, x @ w) + b
per layer over the symmetrically normalized self-looped graph; GCN and
SAGE put ReLU and dropout between layers. `amp` means bf16 operands
into the aggregation with f32 accumulation; the dense products stay f32.
GAT keeps the JAX layer parameters (w [F, H, Ch], a_src, a_dst [H, Ch],
b) and runs in f32 whatever `amp` says, as the JAX pipeline does.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..graph.transform import add_self_loops
from ..kernels import BsdaGraph, gat_aggregate, spmm
from ..kernels.ell import build_ell_graph, gcn_norm_weights
from ..kernels.packed_gat import (
    packed_gat_forward, packed_gat_route, packed_gat_train_forward,
)
from ..parallel.mesh import psum
from ..utils.common import dropout as _dropout

MODEL_GRAPH_KIND = {
    "gcn": "gcn",
    "sage": "sage",
    "gat": "gat",
    "sage_resbn": "sage",
    "sage_bn": "sage",
    "sage_res": "sage",
}
SAGE_RESBN_ARCHS = ("sage_resbn", "sage_bn", "sage_res")


def prepare_graph_ops(edge_index: np.ndarray, num_nodes: int, kind: str):
    """The model-specific ELL encoding (host-side, one-time), as the JAX
    package's prepare_graph_ops builds it; the trainer builds the BSDA
    tables itself (train_gnn.build_graph_ops).

    'sage': mean aggregation over the raw (possibly symmetrized) edges.
    'gcn':  self-loops + symmetric-norm edge weights, sum aggregation.
    'gat':  self-loops, unit validity weights (attention computed in-model).
    """
    if kind == "sage":
        return build_ell_graph(edge_index, num_nodes, mean=True)
    if kind == "gcn":
        ei = add_self_loops(edge_index, num_nodes)
        w = gcn_norm_weights(ei, num_nodes)
        return build_ell_graph(ei, num_nodes, edge_weights=w, mean=False)
    if kind == "gat":
        ei = add_self_loops(edge_index, num_nodes)
        return build_ell_graph(ei, num_nodes, mean=False)
    raise ValueError(f"unknown graph kind {kind}")


BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def _glorot_(w: torch.Tensor, fan_in: int, fan_out: int,
             generator: Optional[torch.Generator]) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


def _linear(d_in: int, d_out: int, bias: bool,
            generator: Optional[torch.Generator]) -> nn.Linear:
    """nn.Linear with the JAX model's init: glorot-uniform weight, zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    _glorot_(lin.weight, d_in, d_out, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class BatchNorm(nn.Module):
    """Counterpart of bn_apply: BatchNorm over the node dimension, running
    stats momentum 0.1 toward the batch statistic, unbiased running var;
    `row_mask` [N] excludes rows (padding) from the batch statistics. With
    a process `group` (rows sharded over its ranks) the count, sum and sum
    of squares are summed over the group, in one all-reduce whose backward
    all-reduces their cotangents (parallel/mesh.py::psum), so every rank
    normalizes with the global statistics."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        self.register_buffer("count", torch.zeros(()))

    def forward(self, h: torch.Tensor, row_mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        if self.training:
            if row_mask is not None:
                m = row_mask.to(h.dtype)[:, None]
                n = row_mask.to(h.dtype).sum()
                s = (h * m).sum(dim=0)
                sq = (h * h * m).sum(dim=0)
            else:
                # a fill on the device, no host-to-device copy (the epoch
                # runs inside a captured CUDA graph)
                n = h.new_full((), float(h.shape[0]))
                s = h.sum(dim=0)
                sq = (h * h).sum(dim=0)
            if group is not None:
                stats = psum(torch.cat([n[None], s, sq]), group)
                n, s, sq = stats[0], stats[1: 1 + h.shape[1]], stats[1 + h.shape[1]:]
            mean = s / n
            var = torch.clamp(sq / n - mean * mean, min=0.0)
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
                self.var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * unbiased)
                self.count.add_(1.0)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + BN_EPS)
        return (h - mean) * inv * self.scale + self.bias


class SageLayer(nn.Module):
    """Counterpart of sage_layer_apply: mean aggregation -> lin_l (with
    bias) + root lin_r (no bias)."""

    def __init__(self, d_in: int, d_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_l = _linear(d_in, d_out, True, generator)
        self.lin_r = _linear(d_in, d_out, False, generator)

    def forward(self, x: torch.Tensor, g, compute_dtype=None) -> torch.Tensor:
        agg = spmm(g, x, compute_dtype=compute_dtype)
        return self.lin_l(agg) + self.lin_r(x)


class GcnLayer(nn.Module):
    """Counterpart of gcn_layer_apply: the dense product first, then the
    normalized aggregation of its result, plus bias."""

    def __init__(self, d_in: int, d_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = _linear(d_in, d_out, False, generator)
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor, g, compute_dtype=None) -> torch.Tensor:
        return spmm(g, self.lin(x), compute_dtype=compute_dtype) + self.bias


class _ConvStack(nn.Module):
    """The plain stacks (counterpart of _stack_apply): conv -> ReLU ->
    dropout between layers, the final conv produces the logits."""

    layer_cls: type
    uses_time_embed = False

    def __init__(self, in_dim: int, cfg: dict,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = int(cfg.get("hidden_dim", 128))
        layers = int(cfg.get("layers", 3))
        if layers < 2:
            raise ValueError(f"layers must be >= 2, got {layers}")
        self.dropout = float(cfg.get("dropout", 0.2))
        self.compute_dtype = torch.bfloat16 if bool(cfg.get("amp", False)) else None
        dims = [in_dim] + [hidden] * (layers - 1) + [2]
        self.layers = nn.ModuleList(
            self.layer_cls(dims[i], dims[i + 1], generator) for i in range(layers))

    def forward(self, x: torch.Tensor, g, t_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                row_mask: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
        h = x
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h, g, self.compute_dtype))
            h = _dropout(h, self.dropout, self.training, generator)
        return self.layers[-1](h, g, self.compute_dtype)


class GCN(_ConvStack):
    layer_cls = GcnLayer


class SAGE(_ConvStack):
    layer_cls = SageLayer


def sinusoid_time_embed(t_idx: torch.Tensor, dim: int,
                        max_timestep: int) -> torch.Tensor:
    """Exact reference sinusoid: t clamped to [0, max_timestep-1],
    normalized to [0,1], freqs k*2pi for k=1..dim//2, [sin, cos] concat,
    zero-padded to odd dims."""
    t = torch.clamp(t_idx.to(torch.float32) - 1.0, 0.0, float(max_timestep - 1))
    t = t / max(float(max_timestep - 1), 1.0)
    half = dim // 2
    freqs = torch.arange(1, half + 1, dtype=torch.float32,
                         device=t.device) * (2.0 * math.pi)
    angles = t[:, None] * freqs[None, :]
    feat = torch.cat([torch.sin(angles), torch.cos(angles)], dim=1)
    if feat.shape[1] < dim:
        feat = torch.cat(
            [feat, feat.new_zeros((feat.shape[0], dim - feat.shape[1]))], dim=1)
    return feat


class SageResBN(nn.Module):
    """SAGE-ResBN: per hidden layer SAGEConv -> BN -> ReLU -> dropout ->
    + residual (identity or linear projection); final SAGEConv -> logits.
    `use_bn`/`residual` select the sage_bn / sage_res variants."""

    def __init__(self, in_dim: int, cfg: dict,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = int(cfg.get("hidden_dim", 128))
        layers = int(cfg.get("layers", 3))
        if layers < 2:
            raise ValueError(f"layers must be >= 2, got {layers}")
        self.dropout = float(cfg.get("dropout", 0.2))
        self.use_bn = bool(cfg.get("use_bn", True))
        self.residual = bool(cfg.get("residual", True))
        self.compute_dtype = torch.bfloat16 if bool(cfg.get("amp", False)) else None
        dim = int(cfg.get("time_embed_dim", 0))
        kind = str(cfg.get("time_embed_type", "learned"))
        self.max_timestep = int(cfg.get("max_timestep", 49))
        if dim <= 0 or kind == "none":
            dim, kind = 0, "none"
        self.time_embed_dim, self.time_embed_type = dim, kind
        self.uses_time_embed = dim > 0
        eff_in = in_dim + dim

        dims = [eff_in] + [hidden] * (layers - 1) + [2]
        res_in = [eff_in] + [hidden] * (layers - 2)
        self.layers = nn.ModuleList(
            SageLayer(dims[i], dims[i + 1], generator) for i in range(layers))
        self.bns = nn.ModuleList(
            BatchNorm(hidden) for _ in range(layers - 1)) if self.use_bn else None
        self.res_projs = nn.ModuleList(
            nn.Identity() if d_in == hidden else _linear(d_in, hidden, False, generator)
            for d_in in res_in) if self.residual else None
        if kind == "learned":
            self.time_emb = nn.Parameter(torch.randn(
                (self.max_timestep, dim), generator=generator))
        else:
            self.time_emb = None

    def _inject_time(self, x: torch.Tensor, t_idx) -> torch.Tensor:
        if self.time_embed_dim <= 0 or t_idx is None:
            return x
        if self.time_embed_type == "learned":
            tidx = torch.clamp(t_idx.long() - 1, 0, self.max_timestep - 1)
            te = self.time_emb[tidx]
        else:
            te = sinusoid_time_embed(t_idx, self.time_embed_dim, self.max_timestep)
        return torch.cat([x, te.to(x.dtype)], dim=1)

    def forward(self, x: torch.Tensor, g, t_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                row_mask: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
        h = self._inject_time(x, t_idx)
        for li in range(len(self.layers) - 1):
            h_in = h
            h = self.layers[li](h, g, self.compute_dtype)
            if self.use_bn:
                h = self.bns[li](h, row_mask, group)
            h = torch.relu(h)
            h = _dropout(h, self.dropout, self.training, generator)
            if self.residual:
                h = h + self.res_projs[li](h_in)
        return self.layers[-1](h, g, self.compute_dtype)


class GatLayer(nn.Module):
    """Counterpart of gat_layer_init/gat_layer_apply: projection to
    `heads` heads of `d_head` features, attention over the self-looped
    edges, heads concatenated (`concat`) or averaged, plus bias."""

    def __init__(self, d_in: int, heads: int, d_head: int, concat: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.concat = concat
        self.w = nn.Parameter(torch.empty(d_in, heads, d_head))
        self.a_src = nn.Parameter(torch.empty(heads, d_head))
        self.a_dst = nn.Parameter(torch.empty(heads, d_head))
        self.b = nn.Parameter(torch.zeros(heads * d_head if concat else d_head))
        _glorot_(self.w, d_in, heads * d_head, generator)
        _glorot_(self.a_src, d_head, 1, generator)
        _glorot_(self.a_dst, d_head, 1, generator)

    def forward(self, x: torch.Tensor, g) -> torch.Tensor:
        xp = torch.einsum("nf,fhc->nhc", x, self.w)
        a_src = torch.einsum("nhc,hc->nh", xp, self.a_src)
        a_dst = torch.einsum("nhc,hc->nh", xp, self.a_dst)
        out = gat_aggregate(g, xp, a_src, a_dst)
        out = out.reshape(out.shape[0], -1) if self.concat else out.mean(dim=1)
        return out + self.b


class GAT(nn.Module):
    """GAT stack: hidden layers with `heads` heads of hidden // heads
    features, ELU and dropout between layers, a single-head final layer
    producing the logits.

    On a BsdaGraph with CUDA tensors the whole stack runs packed through
    the flash kernels (kernels/packed_gat.py): eval through
    packed_gat_forward, training through packed_gat_train_forward; so does
    a rank's BSDA share of a mesh run (ShardedBsda of the halo path,
    RowShardedBsda of the GSPMD row sharding) through the kernels'
    rectangular launches, on CPU tensors through their plain versions. A
    BsdaGraph with CPU tensors runs layer by layer through the plain
    formulation (forward_plain), differentiated by autograd; an EllGraph
    (the explainer's subgraph) and a RowShardedEll layer by layer through
    the ELL masked softmax on either device, as the JAX model does. There
    is no switch between the kernels and the plain version:
    `gat_fused_vjp: false`, the JAX package's autodiff comparator, is
    refused."""

    uses_time_embed = False

    def __init__(self, in_dim: int, cfg: dict,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = int(cfg.get("hidden_dim", 128))
        layers = int(cfg.get("layers", 3))
        heads = int(cfg.get("heads", 4))
        if layers < 2:
            raise ValueError(f"layers must be >= 2, got {layers}")
        d_head = hidden // heads
        self.dropout = float(cfg.get("dropout", 0.2))
        if cfg.get("gat_fused_vjp", "auto") not in ("auto", True):
            raise ValueError(
                f"gat_fused_vjp: {cfg['gat_fused_vjp']!r} is not supported: on a "
                "CUDA device GAT always runs the flash kernels, on the CPU always "
                "the plain formulation (allowed values: true, auto)")
        dims = [in_dim] + [heads * d_head] * (layers - 1)
        self.layers = nn.ModuleList(
            [GatLayer(d, heads, d_head, True, generator) for d in dims[:-1]]
            + [GatLayer(dims[-1], 1, 2, False, generator)])

    def forward(self, x: torch.Tensor, g, t_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                row_mask: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
        packed = x.is_cuda if isinstance(g, BsdaGraph) else packed_gat_route(g) is not None
        if not packed:
            return self.forward_plain(x, g, generator)
        params = [dict(w=l.w, a_src=l.a_src, a_dst=l.a_dst, b=l.b)
                  for l in self.layers]
        if self.training:
            return packed_gat_train_forward(params, x, g, self.dropout, generator)
        return packed_gat_forward(params, x, g)

    def forward_plain(self, x: torch.Tensor, g,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The stack layer by layer through kernels.gat_aggregate: on a
        BsdaGraph the plain version that CPU tensors take and the kernels'
        path is held against, on an EllGraph the ELL attention."""
        h = x
        for layer in self.layers[:-1]:
            h = torch.nn.functional.elu(layer(h, g))
            h = _dropout(h, self.dropout, self.training, generator)
        return self.layers[-1](h, g)


_ARCH_CLASS = {"gcn": GCN, "sage": SAGE, "gat": GAT}


def build_model(arch: str, in_dim: int, cfg: dict,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Model factory with the JAX package's config keys and defaults."""
    if arch in SAGE_RESBN_ARCHS:
        return SageResBN(in_dim, cfg, generator)
    if arch in _ARCH_CLASS:
        return _ARCH_CLASS[arch](in_dim, cfg, generator)
    raise ValueError(f"Unknown arch {arch!r}")
