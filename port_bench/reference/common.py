"""Plain PyTorch and NumPy pieces that every reference model shares: the
trainer's preprocessing, the two node orders the program trains in, the
dropout masks, rounding, the loss, the gradient clip, Adam and the
validation PR-AUC.

Nothing here imports the program: each piece is written from the
semantics the configuration states, and works in the graph's own node
ids. The node orders matter only for the dropout masks, which the
program draws row by row in its own order.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

CHUNK = 128  # the packed rows of GAT's masks are padded to whole chunks


def temporal_masks(y, t, t_train_end: int, t_val_end: int, window_k):
    """(train, val) masks: labelled nodes of the last `window_k` train
    timesteps (every train timestep when None), and of (t_train_end,
    t_val_end]."""
    labeled = y >= 0
    lo = 1 if window_k is None else max(1, t_train_end - int(window_k) + 1)
    train = (t >= lo) & (t <= t_train_end) & labeled
    val = (t > t_train_end) & (t <= t_val_end) & labeled
    return train, val


def bfs_rank(edge_index: np.ndarray, n: int, blocks: np.ndarray) -> np.ndarray:
    """rank[node] = row: breadth-first over the undirected graph, starting
    from the lowest unvisited id, each node's neighbours in the order of
    the edges that join them; the nodes of one block (timestep)
    contiguous, blocks in order."""
    if np.any(np.diff(blocks) < 0):
        relabel = np.argsort(np.argsort(blocks, kind="stable"), kind="stable")
        inner = bfs_rank(relabel[edge_index], n, blocks[np.argsort(relabel)])
        return inner[relabel]
    u = np.stack([edge_index[0], edge_index[1]], axis=1).reshape(-1).astype(np.int64)
    v = np.stack([edge_index[1], edge_index[0]], axis=1).reshape(-1).astype(np.int64)
    order = np.argsort(u, kind="stable")
    nbr = v[order].tolist()
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=n), out=ptr[1:])
    ptr = ptr.tolist()
    rank = [-1] * n
    seen = bytearray(n)
    nxt = 0
    for start in range(n):
        if seen[start]:
            continue
        seen[start] = 1
        queue = deque([start])
        while queue:
            a = queue.popleft()
            rank[a] = nxt
            nxt += 1
            for b in nbr[ptr[a]:ptr[a + 1]]:
                if not seen[b]:
                    seen[b] = 1
                    queue.append(b)
    return np.asarray(rank, np.int64)


def degree_bucket_rank(dst: np.ndarray, n: int) -> np.ndarray:
    """rank[node] = row: nodes grouped by in-degree rounded up to a power
    of two, narrowest group first, ids ascending in a group, nodes without
    in-edges last."""
    deg = np.bincount(dst, minlength=n)
    width = np.zeros(n, np.int64)
    nz = deg > 0
    width[nz] = 1 << np.ceil(np.log2(deg[nz])).astype(np.int64)
    order = np.lexsort((np.arange(n), np.where(nz, width, np.iinfo(np.int64).max)))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    return rank


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10-bit mantissa, to nearest even: what the
    tensor cores read of an f32 operand with TF32 on. Bit arithmetic, so
    it gives the same numbers on either device."""
    bits = t.contiguous().view(torch.int32)
    keep = bits + 0xFFF + ((bits >> 13) & 1)
    return (keep & ~0x1FFF).view(torch.float32)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t through fp8 e4m3 with one scale for the tensor (its largest
    magnitude to e4m3's largest, 448), as an fp8 product takes its
    operands."""
    amax = t.abs().amax()
    scale = torch.where(amax > 0, 448.0 / amax, torch.ones_like(amax))
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class _Tf32Mm(torch.autograd.Function):
    """a @ b with the operands of the product and of its backward's two
    products in TF32, as the tensor cores take them with TF32 on."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return rg @ rb.t(), ra.t() @ rg


class Precision:
    """Where the reference rounds. `agg` is the aggregation's operand
    precision: "f32", "bf16" (the configuration's amp) or "fp8" (the
    control one step below bf16); `tf32` puts the dense products in TF32
    (the control one step below the f32 the configurations state)."""

    def __init__(self, agg: str = "f32", tf32: bool = False):
        self.agg, self.tf32 = agg, tf32

    def agg_operand(self, t: torch.Tensor) -> torch.Tensor:
        return {"f32": lambda v: v, "bf16": round_bf16, "fp8": round_fp8}[self.agg](t)

    def agg_result(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.agg == "f32" else round_bf16(t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Tf32Mm.apply(a, b) if self.tf32 else a @ b


def dropout_masks(rows: int, width: int, draws: int, gen: torch.Generator,
                  keep: float, device) -> list:
    """`draws` keep-masks [rows, width], drawn one after another from
    `gen` as uniform numbers below `keep`: the order and the shapes in
    which the program draws them decide the bits."""
    return [torch.rand((rows, width), generator=gen, device=device) < keep
            for _ in range(draws)]


def class_weights(y_train: np.ndarray) -> np.ndarray:
    """[w_neg, w_pos] = (P + N) / (2 count)."""
    pos = int((y_train == 1).sum())
    neg = int((y_train == 0).sum())
    if pos == 0 or neg == 0:
        return np.ones(2, np.float32)
    return np.array([(pos + neg) / (2.0 * neg), (pos + neg) / (2.0 * pos)], np.float32)


def weighted_ce(logits: torch.Tensor, y: torch.Tensor, cw: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """The class-weighted cross entropy of the masked rows, summed and
    divided by their count (not by the sum of their weights)."""
    logp = torch.log_softmax(logits, dim=1)
    ce = -logp.gather(1, y[:, None])[:, 0] * cw[y]
    m = mask.to(ce.dtype)
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def clip_grads(grads: list, max_norm: float) -> list:
    """Scaled so that their joint norm is at most `max_norm`."""
    if max_norm <= 0:
        return grads
    total = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return [g * coef for g in grads]


class Adam:
    """Adam with L2 weight decay added to the gradient before the moments
    (betas 0.9, 0.999, eps 1e-8). `seen[i]` is the gradient as it enters
    the moments at the first step; `steps` holds, for every step, each
    parameter's (bias-corrected first moment, gradient) as the moments took
    them."""

    def __init__(self, params: list, lr: float, weight_decay: float):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0
        self.seen = None
        self.steps = []

    @torch.no_grad()
    def step(self, grads: list) -> None:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        eff = [g + self.wd * p for g, p in zip(grads, self.params)]
        if self.seen is None:
            self.seen = [g.clone() for g in eff]
        taken = []
        for p, g, m, v in zip(self.params, eff, self.m, self.v):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + eps))
            taken.append((m_hat, g.clone()))
        self.steps.append(taken)


def pr_auc(y: np.ndarray, score: np.ndarray) -> float:
    """Average precision of the positives: each positive adds the
    precision at the end of its group of tied scores, over the positives."""
    y = np.asarray(y).astype(np.int64)
    s = np.asarray(score, np.float64)
    total = int(y.sum())
    if total == 0 or s.size == 0:
        return 0.0
    order = np.argsort(-s, kind="stable")
    ys, ss = y[order], s[order]
    prec = np.cumsum(ys) / np.arange(1, ys.size + 1)
    last = np.r_[ss[:-1] != ss[1:], True]
    end = np.minimum.accumulate(np.where(last, np.arange(ys.size), ys.size - 1)[::-1])[::-1]
    return float(prec[end][ys > 0].sum() / total)
