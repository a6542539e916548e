"""A plain reference of EvolveGCN-O for the tests: plain torch in float32,
a Python loop over the snapshots with a dense normalized adjacency each.
Imports nothing of either package.

Pareja et al., "EvolveGCN: Evolving Graph Convolutional Networks for
Dynamic Graphs" (AAAI 2020, arXiv:1902.10191), and its code
(github.com/IBM/EvolveGCN: egcn_o.py, models.py::Classifier). Per GRCU
layer l and snapshot t = 1..T:

    Q_t = GRU(Q_{t-1}), the code's mat_GRU_cell with Q as input and hidden:
        U  = sigmoid(W_u Q + U_u Q + B_u)
        R  = sigmoid(W_r Q + U_r Q + B_r)
        H~ = tanh(W_h Q + U_h (R o Q) + B_h)
        Q_t = (1 - U) o Q + U o H~
    H_t^{l+1} = act(A_t H_t^l Q_t),  A_t = D^-1/2 (A_t + I) D^-1/2

then the classifier Linear -> ReLU -> Linear to 2 logits.

Departures, each as the port makes it:
  - the paper writes an LSTM for -O; this follows the code's GRU;
  - act is LeakyReLU of slope 11/48, the code's RReLU in its eval form
    (random slopes in training are draws no comparison can follow);
  - one recurrence over all T snapshots per full-batch step, where the code
    trains on windows of num_hist_steps restarted from Q_0;
  - A_t over the snapshot's directed edges (a repeated edge counts each
    time), degrees counted at the destination after the self-loops, as the
    port's GCN normalization does; the code's normalization is symmetric
    on its own adjacency.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SLOPE = 11.0 / 48.0
GATES = ("u", "r", "h")


def param_names(layers: int) -> list:
    """The parameters' names, as the port's module names them."""
    names = []
    for i in range(layers):
        names.append(f"grcu.{i}.q0")
        for g in GATES:
            names += [f"grcu.{i}.w_{g}", f"grcu.{i}.u_{g}", f"grcu.{i}.b_{g}"]
    return names + ["cls.0.weight", "cls.0.bias", "cls.1.weight", "cls.1.bias"]


def dense_adjacency(edge_index: np.ndarray, nodes: np.ndarray) -> torch.Tensor:
    """A_t [n_t, n_t] of the edges among `nodes` (rows: destinations)."""
    pos = {int(v): i for i, v in enumerate(nodes)}
    n = len(nodes)
    a = torch.eye(n, dtype=torch.float32)
    for s, d in edge_index.T:
        if int(s) in pos and int(d) in pos:
            a[pos[int(d)], pos[int(s)]] += 1.0
    deg = a.sum(1)
    inv = deg.pow(-0.5)
    return inv[:, None] * a * inv[None, :]


def gru(P: dict, i: int, q: torch.Tensor) -> torch.Tensor:
    p = {k: P[f"grcu.{i}.{k}"] for g in GATES for k in (f"w_{g}", f"u_{g}", f"b_{g}")}
    u = torch.sigmoid(p["w_u"] @ q + p["u_u"] @ q + p["b_u"])
    r = torch.sigmoid(p["w_r"] @ q + p["u_r"] @ q + p["b_r"])
    h = torch.tanh(p["w_h"] @ q + p["u_h"] @ (r * q) + p["b_h"])
    return (1.0 - u) * q + u * h


def forward(P: dict, x: torch.Tensor, timestep: np.ndarray, edge_index: np.ndarray,
            layers: int, steps: int) -> torch.Tensor:
    """Logits [N, 2] in the graph's own node order."""
    snaps = [np.flatnonzero(timestep == t) for t in range(1, steps + 1)]
    adj = [dense_adjacency(edge_index, nodes) for nodes in snaps]
    h = x
    for i in range(layers):
        q = P[f"grcu.{i}.q0"]
        rows = []
        for nodes, a in zip(snaps, adj):
            q = gru(P, i, q)
            rows.append(F.leaky_relu(a @ (h[nodes] @ q), SLOPE))
        order = np.concatenate(snaps)
        out = torch.empty((x.shape[0], q.shape[1]), dtype=torch.float32)
        out = out.index_copy(0, torch.as_tensor(order), torch.cat(rows))
        h = out
    z = torch.relu(h @ P["cls.0.weight"].t() + P["cls.0.bias"])
    return z @ P["cls.1.weight"].t() + P["cls.1.bias"]
