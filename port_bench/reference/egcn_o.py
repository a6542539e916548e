"""Plain reference of EvolveGCN-O (arch egcn_o): Pareja et al., "EvolveGCN:
Evolving Graph Convolutional Networks for Dynamic Graphs" (AAAI 2020,
arXiv:1902.10191) and its code (github.com/IBM/EvolveGCN: egcn_o.py,
models.py::Classifier). Per GRCU layer and snapshot t = 1..max_timestep:

    Q_t = GRU(Q_{t-1}), the code's mat_GRU_cell with Q as input and hidden:
        U  = sigmoid(W_u Q + U_u Q + B_u)
        R  = sigmoid(W_r Q + U_r Q + B_r)
        H~ = tanh(W_h Q + U_h (R o Q) + B_h)
        Q_t = (1 - U) o Q + U o H~
    H_t^{l+1} = act(A_t H_t^l Q_t),  A_t = D^-1/2 (A_t + I) D^-1/2

then Linear -> ReLU -> Linear to two logits. act is LeakyReLU of slope
11/48 (the code's RReLU in its eval form); one recurrence over all
snapshots a full-batch step (the code trains windows restarted from Q_0);
A_t over the snapshot's directed edges with a self-loop each, degrees at
the destination. All in f32: no dropout, no amp.

Each snapshot's rows are picked by their timestep and multiplied by its
Q_t; the aggregation is one index_add_ over the whole graph's edge list
(every edge lies within a snapshot), source and destination scaled by
deg^-1/2. Nothing here follows the program's row order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import workcount as W

SLOPE = 11.0 / 48.0
GATES = ("u", "r", "h")


def _dims(cfg: dict, in_dim: int):
    hidden, layers = int(cfg["hidden_dim"]), int(cfg["layers"])
    return [in_dim] + [hidden] * layers, int(cfg.get("cls_feats", hidden)), \
        int(cfg.get("max_timestep", 49))


def param_spec(cfg: dict, in_dim: int) -> list:
    """(name, shape, init) of every parameter, named as the program's."""
    dims, cls, _ = _dims(cfg, in_dim)
    spec = []
    for i in range(len(dims) - 1):
        d, c = dims[i], dims[i + 1]
        spec.append((f"grcu.{i}.q0", (d, c), ("glorot", d, c)))
        for g in GATES:
            spec += [(f"grcu.{i}.w_{g}", (d, d), ("glorot", d, d)),
                     (f"grcu.{i}.u_{g}", (d, d), ("glorot", d, d)),
                     (f"grcu.{i}.b_{g}", (d, c), ("zeros",))]
    hidden = dims[-1]
    return spec + [("cls.0.weight", (cls, hidden), ("glorot", hidden, cls)),
                   ("cls.0.bias", (cls,), ("zeros",)),
                   ("cls.1.weight", (2, cls), ("glorot", cls, 2)),
                   ("cls.1.bias", (2,), ("zeros",))]


def mask_layout(cfg: dict, n: int, device_type: str):
    """No dropout: no masks drawn."""
    return n, 1, 0


class _GcnAgg(torch.autograd.Function):
    """out[d] = s[d] * sum over d's in-edges of s[src] x[src] (self-loops
    among the edges), operands and result rounded as `prec` says."""

    @staticmethod
    def forward(ctx, x, src, dst, s, prec):
        y = prec.agg_operand(x * s[:, None])
        out = torch.zeros_like(x).index_add_(0, dst, y[src]) * s[:, None]
        ctx.save_for_backward(src, dst, s)
        ctx.prec = prec
        return prec.agg_result(out)

    @staticmethod
    def backward(ctx, g):
        src, dst, s = ctx.saved_tensors
        p = ctx.prec
        rhs = p.agg_operand(p.agg_result(g) * s[:, None])
        out = torch.zeros_like(g).index_add_(0, src, rhs[dst]) * s[:, None]
        return p.agg_result(out), None, None, None, None


class Model:
    def __init__(self, cfg: dict, graph, precision):
        self.cfg, self.g, self.p = cfg, graph, precision
        _, _, self.steps = _dims(cfg, graph.x.shape[1])
        self.layers = int(cfg["layers"])
        loops = torch.arange(graph.n, device=graph.src.device)
        self.src = torch.cat([graph.src, loops])
        self.dst = torch.cat([graph.dst, loops])
        deg = torch.bincount(self.dst, minlength=graph.n).to(torch.float32)
        self.s = deg.rsqrt()
        self.snaps = [torch.nonzero(graph.t == t).flatten() for t in range(1, self.steps + 1)]

    def buffers(self) -> dict:
        """EvolveGCN-O keeps no running statistics."""
        return {}

    def _gru(self, P: dict, i: int, q: torch.Tensor) -> torch.Tensor:
        mm = self.p.mm

        def w(name):
            return P[f"grcu.{i}.{name}"]

        u = torch.sigmoid(mm(w("w_u"), q) + mm(w("u_u"), q) + w("b_u"))
        r = torch.sigmoid(mm(w("w_r"), q) + mm(w("u_r"), q) + w("b_r"))
        h = torch.tanh(mm(w("w_h"), q) + mm(w("u_h"), r * q) + w("b_h"))
        return (1.0 - u) * q + u * h

    def forward(self, P: dict, training: bool, masks=None) -> torch.Tensor:
        h = self.g.x
        for i in range(self.layers):
            q = P[f"grcu.{i}.q0"]
            y = h.new_zeros((h.shape[0], q.shape[1]))
            for rows in self.snaps:
                q = self._gru(P, i, q)
                y = y.index_copy(0, rows, self.p.mm(h[rows], q))
            h = F.leaky_relu(_GcnAgg.apply(y, self.src, self.dst, self.s, self.p), SLOPE)
        z = torch.relu(self.p.mm(h, P["cls.0.weight"].t()) + P["cls.0.bias"])
        return self.p.mm(z, P["cls.1.weight"].t()) + P["cls.1.bias"]


def _evolve_step(d: int, c: int, flops_products: int, reads: int, writes: int) -> W.Work:
    """One step of the weight evolution: `flops_products` products of a
    [d, d] by a [d, c] matrix; the six [d, d] weights read, `reads` and
    `writes` [d, c] operands read and written."""
    return W.Work("evolve", 2.0 * flops_products * d * d * c,
                  4.0 * (6 * d * d + (reads + writes) * d * c), "f32")


def epoch_work(cfg: dict, n: int, edges: int, in_dim: int) -> list:
    """The work of one epoch (training forward, backward, eval forward):
    'spmm' aggregations (f32, the self-loops among the nonzeros, a source
    and a destination scale), 'dense' row products (grouped by snapshot)
    and classifier products, and 'evolve', the weights' evolution step by
    step. `edges` counts the graph's edges without the self-loops.

    A forward step reads the six [d, d] weights, the three biases and Q,
    and writes Q' (the training forward also U, R and H~, kept for the
    backward): six products. A backward step reads the weights, dQ', U, R,
    H~, Q and Q's use cotangent and writes dQ: ten products (U_h^T dA_h,
    the five products into dQ, and the four weight-gradient products: W_u's
    and U_u's gradients are one sum, as are W_r's and U_r's). The weights'
    and biases' gradients are written once."""
    dims, cls, steps = _dims(cfg, in_dim)
    hidden = dims[-1]
    spmm = W.spmm("spmm", n, edges + n, hidden, "f32", True)
    spmm = W.Work("spmm", spmm.flops, spmm.bytes + 4 * n, "f32")  # the source scale too
    work = [spmm] * (3 * (len(dims) - 1))
    for i in range(len(dims) - 1):
        d, c = dims[i], dims[i + 1]
        rows = W.dense("dense", n, d, c, "f32")
        # training and eval forward, the weights' gradient; the input's
        # gradient where the input is not the features
        work += [rows] * (3 if i == 0 else 4)
        work += [_evolve_step(d, c, 6, 4, 4)] * steps   # training forward
        work += [_evolve_step(d, c, 6, 4, 1)] * steps   # eval forward
        work += [_evolve_step(d, c, 10, 6, 1)] * steps  # backward
        work.append(W.Work("evolve", 0.0, 4.0 * (6 * d * d + 3 * d * c), "f32"))
    work += [W.dense("dense", n, hidden, cls, "f32"), W.dense("dense", n, cls, 2, "f32")] * 4
    return work
