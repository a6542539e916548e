"""Fixed-shape neighbour-sampled mini-batch training (port of
elliptic_gnn_tpu/train/sampler.py), `mini_batch: true`.

  - layered fanout sampling WITH replacement over a host CSR of incoming
    edges, vectorised in numpy (PyG's NeighborLoader samples without
    replacement; the JAX package's behaviour is copied, not fixed);
  - the union subgraph padded to a static node budget N_SUB and packed as
    one fixed-width ELL bucket (every row W = 1 + sum(fanout) slots);
  - the loss on the first `batch_size` rows (the seeds) under `seed_mask`;
    BatchNorm's batch statistics run over all N_SUB rows, padding rows
    (node 0, no edges) included, as in the JAX package.

The sampler's `default_rng(seed)` and the loop's `host_rng` (which permutes
the train nodes) are two streams called in the JAX package's order (each
epoch the train batches, then the val batches), so one seed gives the same
batches in both packages. The aggregation is the ELL gather
(kernels/ell.py) on either device, as the JAX package runs it in plain XLA.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..kernels.ell import EllGraph, build_csr
from ..models import MODEL_GRAPH_KIND
from ..utils import metrics as M
from ..utils.common import upload
from .train_gnn import _snapshot


class NeighborSampler:
    """Host-side layered fanout sampler over incoming edges."""

    def __init__(self, edge_index: np.ndarray, num_nodes: int, fanout, batch_size: int,
                 kind: str, seed: int = 0):
        self.num_nodes = num_nodes
        self.fanout = [int(f) for f in fanout]
        self.batch_size = int(batch_size)
        self.kind = kind
        self.rng = np.random.default_rng(seed)
        indptr, col, _ = build_csr(
            np.asarray(edge_index[0], np.int64), np.asarray(edge_index[1], np.int64),
            num_nodes,
        )
        self.indptr, self.col = indptr, col
        self.deg = np.diff(indptr)
        # static shape budgets
        mult = 1
        budget = self.batch_size
        for f in self.fanout:
            mult *= f
            budget += self.batch_size * mult
        self.n_sub = int(min(budget, num_nodes))
        # row width: self-loop slot + per-hop fanout contributions
        self.width = 1 + sum(self.fanout)

    def _sample_neighbors(self, frontier: np.ndarray, f: int):
        """For each frontier node draw f in-neighbours with replacement;
        nodes of in-degree 0 yield masked slots."""
        deg = self.deg[frontier]
        has = deg > 0
        r = self.rng.random((frontier.size, f))
        offs = np.floor(r * np.maximum(deg, 1)[:, None]).astype(np.int64)
        idx = self.indptr[frontier][:, None] + offs
        nbr = self.col[np.minimum(idx, self.col.size - 1 if self.col.size else 0)]
        mask = np.broadcast_to(has[:, None], nbr.shape)
        return nbr, mask

    def sample_batch(self, seeds: np.ndarray):
        """(node_ids [N_SUB] int64, ell: EllGraph on the CPU, n_seed,
        seed_mask [batch_size] float32).

        node_ids: global ids, seeds first; padding rows repeat node 0 with
        no adjacency. The ELL table indexes local rows; its rows are the
        node order (inv_perm None: the JAX package's is the identity)."""
        b = self.batch_size
        n_seed = seeds.size
        seeds_p = np.zeros(b, dtype=np.int64)
        seeds_p[:n_seed] = seeds

        all_src, all_dst = [], []
        frontier = seeds_p[:n_seed]
        for f in self.fanout:
            nbr, mask = self._sample_neighbors(frontier, f)
            dst = np.repeat(frontier, f).reshape(frontier.size, f)
            all_src.append(nbr[mask])
            all_dst.append(dst[mask])
            frontier = np.unique(nbr[mask])
            if frontier.size == 0:
                break

        if all_src:
            e_src = np.concatenate(all_src)
            e_dst = np.concatenate(all_dst)
        else:
            e_src = np.zeros(0, np.int64)
            e_dst = np.zeros(0, np.int64)

        # local relabelling: seeds occupy rows [0, n_seed)
        uniq = np.unique(np.concatenate([seeds_p[:n_seed], e_src, e_dst]))
        rest = np.setdiff1d(uniq, seeds_p[:n_seed], assume_unique=False)
        order = np.concatenate([seeds_p[:n_seed], rest])
        if order.size > self.n_sub:
            # drop overflow nodes (and their edges) beyond the static budget
            order = order[: self.n_sub]
            kept_sorted = np.sort(order)
            in_s = kept_sorted[
                np.clip(np.searchsorted(kept_sorted, e_src), 0, order.size - 1)
            ] == e_src
            in_d = kept_sorted[
                np.clip(np.searchsorted(kept_sorted, e_dst), 0, order.size - 1)
            ] == e_dst
            keep_e = in_s & in_d
            e_src, e_dst = e_src[keep_e], e_dst[keep_e]
        sorter = np.argsort(order, kind="stable")
        order_sorted = order[sorter]
        l_src = sorter[np.searchsorted(order_sorted, e_src)].astype(np.int64)
        l_dst = sorter[np.searchsorted(order_sorted, e_dst)].astype(np.int64)

        node_ids = np.zeros(self.n_sub, dtype=np.int64)
        node_ids[: order.size] = order

        # dedup repeated sampled edges per (src, dst)
        if l_src.size:
            key = l_dst * self.n_sub + l_src
            key_u = np.unique(key)
            l_dst_u = (key_u // self.n_sub).astype(np.int64)
            l_src_u = (key_u % self.n_sub).astype(np.int64)
        else:
            l_dst_u = l_src_u = np.zeros(0, np.int64)

        nbr, w, scale = self._fixed_ell(l_src_u, l_dst_u, order.size)
        ell = EllGraph(
            nbrs=(torch.from_numpy(nbr),),
            weights=(torch.from_numpy(w),),
            rows=(torch.arange(self.n_sub, dtype=torch.int64),),
            inv_perm=None,
            row_scale=(torch.from_numpy(scale),),
            num_nodes=self.n_sub,
            widths=(self.width,),
            n_zero_deg=0,
        )
        seed_mask = np.zeros(b, dtype=np.float32)
        seed_mask[:n_seed] = 1.0
        return node_ids, ell, n_seed, seed_mask

    def _fixed_ell(self, l_src, l_dst, n_valid):
        """Pack local edges into a fixed [N_SUB, W] table with the model
        kind's semantics (sage: mean; gcn: self-loops + sym-norm; gat:
        self-loops + validity); edges past a row's width are dropped."""
        n, wdt = self.n_sub, self.width
        add_loops = self.kind in ("gcn", "gat")
        nbr = np.zeros((n, wdt), dtype=np.int64)
        w = np.zeros((n, wdt), dtype=np.float32)
        fill = np.zeros(n, dtype=np.int64)

        if add_loops:
            rows = np.arange(n_valid)
            nbr[rows, 0] = rows
            w[rows, 0] = 1.0
            fill[:n_valid] = 1

        # slot of each edge: sort by destination, offset within it
        if l_dst.size:
            srt = np.argsort(l_dst, kind="stable")
            d_s, s_s = l_dst[srt], l_src[srt]
            counts = np.bincount(d_s, minlength=n)
            seg_start = np.cumsum(np.r_[0, counts[:-1]])
            within = np.arange(d_s.size) - seg_start[d_s] + fill[d_s]
            ok = within < wdt
            nbr[d_s[ok], within[ok]] = s_s[ok]
            w[d_s[ok], within[ok]] = 1.0
            fill = np.minimum(fill + counts, wdt)

        deg = (w > 0).sum(axis=1).astype(np.float32)
        if self.kind == "sage":
            scale = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0).astype(np.float32)
        elif self.kind == "gcn":
            dinv = np.where(deg > 0, deg**-0.5, 0.0)
            w = w * dinv[nbr] * dinv[:, None]
            scale = np.ones(n, dtype=np.float32)
        else:  # gat: validity only
            scale = np.ones(n, dtype=np.float32)
        return nbr, w.astype(np.float32), scale


def train_loop_minibatch(cfg, data, inputs, model, opt, loss_fn, logger, device):
    """Epoch loop over sampled batches, early stop on the sampled val
    PR-AUC with `patience` (the JAX package's loop). `inputs` holds the
    full node arrays on `device` (train_gnn._Inputs); each batch gathers its
    rows there by node_ids. Returns (best state_dict, best_val, epochs_run,
    epoch_seconds, loop_info) as the full-batch loops do; loop_info holds
    the budget `n_sub`, the row width `batch_width` and per epoch the mean
    host ms per train batch of sampling (`sample_ms`) and of the step
    (`step_ms`: upload, forward, backward, Adam and the loss read back)."""
    kind = MODEL_GRAPH_KIND[cfg["arch"]]
    fanout = cfg.get("fanout", [10, 10])
    batch_size = int(cfg.get("batch_size", 8192))
    seed = int(cfg.get("seed", 42))
    sampler = NeighborSampler(
        data.edge_index, data.num_nodes, fanout, batch_size, kind, seed
    )
    use_time = model.uses_time_embed
    use_time_loss = str(cfg.get("time_loss_weighting", "none")) != "none"
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    grad_clip = float(cfg.get("grad_clip", 0) or 0)

    def batch_inputs(node_ids, ell):
        ids = upload(node_ids, device)
        return ids, inputs.x[ids], inputs.t[ids] if use_time else None, ell.to(device)

    def train_step(node_ids, ell, seed_mask):
        ids, xb, tb, ell_d = batch_inputs(node_ids, ell)
        # a batch larger than the graph (n_sub = num_nodes < batch_size)
        # holds every seed in its n_sub rows; the JAX loop's shapes clash there
        b = min(batch_size, sampler.n_sub)
        mask = upload(seed_mask[:b], device)
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(xb, ell_d, tb, generator=gen)
        seed_ids = ids[:b]
        loss = loss_fn(model, logits[:b], inputs.y[seed_ids],
                       inputs.t[seed_ids] if use_time_loss else None, mask)
        loss.backward()
        if grad_clip > 0:
            torch.nn.utils.clip_grad_norm_(model.parameters(), grad_clip)
        opt.step()
        return float(loss.detach())

    def eval_step(node_ids, ell, n_seed):
        _, xb, tb, ell_d = batch_inputs(node_ids, ell)
        model.eval()
        with torch.no_grad():
            logits = model(xb, ell_d, tb)
        return torch.softmax(logits[:n_seed], dim=1)[:, 1].cpu().numpy()

    train_idx = np.where(data.train_mask)[0]
    val_idx = np.where(data.val_mask)[0]
    host_rng = np.random.default_rng(seed)

    best, best_val, bad = _snapshot(model), -1.0, 0
    patience = int(cfg.get("patience", 20))
    epochs_run, epoch_seconds, sample_ms, step_ms = 0, [], [], []

    for epoch in range(1, int(cfg["max_epochs"]) + 1):
        t_epoch = time.time()
        perm = host_rng.permutation(train_idx)
        total_loss, total_n, t_sample, t_step = 0.0, 0, 0.0, 0.0
        for i in range(0, perm.size, batch_size):
            seeds = perm[i : i + batch_size]
            t0 = time.time()
            node_ids, ell, n_seed, seed_mask = sampler.sample_batch(seeds)
            t1 = time.time()
            total_loss += train_step(node_ids, ell, seed_mask) * n_seed
            t_sample, t_step = t_sample + t1 - t0, t_step + time.time() - t1
            total_n += n_seed
        loss_f = total_loss / max(total_n, 1)
        n_batches = max(-(-perm.size // batch_size), 1)
        sample_ms.append(1e3 * t_sample / n_batches)
        step_ms.append(1e3 * t_step / n_batches)

        ys, ps = [], []
        for i in range(0, val_idx.size, batch_size):
            seeds = val_idx[i : i + batch_size]
            node_ids, ell, n_seed, _ = sampler.sample_batch(seeds)
            ps.append(eval_step(node_ids, ell, n_seed))
            ys.append(data.y[seeds])
        y_val = np.concatenate(ys) if ys else np.zeros(0)
        p_val = np.concatenate(ps) if ps else np.zeros(0)
        pr_val = (
            0.0 if y_val.size == 0 else M.pr_auc_illicit((y_val == 1).astype(int), p_val)
        )
        logger.log_epoch(epoch, loss_f, pr_val)
        epochs_run += 1
        epoch_seconds.append(time.time() - t_epoch)

        if pr_val > best_val:
            best, best_val, bad = _snapshot(model), pr_val, 0
        else:
            bad += 1
        if epoch % 10 == 0 or epoch == 1:
            print(
                f"Epoch {epoch:4d} | loss {loss_f:.4f} | "
                f"val PR-AUC(illicit) {pr_val:.4f} (best {best_val:.4f})"
            )
        if bad >= patience:
            print("Early stopping.")
            break

    info = {"n_sub": sampler.n_sub, "batch_width": sampler.width,
            "sample_ms": sample_ms, "step_ms": step_ms}
    return best, best_val, epochs_run, epoch_seconds, info
