"""Jobs that the multi-rank port tests run in every rank of a gloo process
group (tests/test_torch_port_multihost.py starts the ranks with
parallel/multihost.py::spawn_ranks, so each process here is one rank of the
EGNN_* path). Imports torch and the port only: no JAX in a rank.

Each job writes what the test compares into `root` (one .npz or .json per
rank where the ranks' shares differ). The ranks do not import tensorboard
(RunLogger treats it as optional): its import takes seconds a process.
"""
from __future__ import annotations

import json
import os
import pickle
import sys

import numpy as np
import torch

from elliptic_gnn_tpu_torch.kernels import bsda
from elliptic_gnn_tpu_torch.parallel import multihost, shardmap_step
from elliptic_gnn_tpu_torch.parallel.mesh import make_mesh

GAT_HEADS, GAT_CH = 2, 4


def band_graph(n: int = 2900, seed: int = 5, n_band: int = 600):
    """A symmetrized, BFS-renumbered synthetic graph of n nodes plus n_band
    random edges (both ways) between nodes at most 250 rows apart: with
    depth 3 it has a residual spill, halo fix-ups at every shard boundary
    and a halo of two chunks. Returns (edge_index [2, E] int64, n)."""
    from elliptic_gnn_tpu_torch.graph import synthetic
    from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges

    data = symmetrize_edges(synthetic.generate(num_nodes=n, num_timesteps=10, seed=seed))
    data = data.renumber(bsda.bfs_order(data.edge_index, n, data.timestep))
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, n_band)
    dst = np.clip(src + rng.integers(-250, 250, n_band), 0, n - 1)
    ei = np.concatenate([data.edge_index, np.stack([src, dst]),
                         np.stack([dst, src])], axis=1).astype(np.int64)
    return ei, n


def agg_inputs(n_rows: int, feat: int, seed: int = 7):
    """x [n_rows, feat] and the loss weights w [feat], from a seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_rows, feat)).astype(np.float32),
            rng.standard_normal(feat).astype(np.float32))


def gat_inputs(n_rows: int, seed: int = 8):
    """x_proj [n_rows, H, Ch], a_src, a_dst [n_rows, H], cotangent
    weights [H, Ch], from a seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_rows, GAT_HEADS, GAT_CH)).astype(np.float32),
            rng.standard_normal((n_rows, GAT_HEADS)).astype(np.float32),
            rng.standard_normal((n_rows, GAT_HEADS)).astype(np.float32),
            rng.standard_normal((GAT_HEADS, GAT_CH)).astype(np.float32))


def _sharded(kind: str, mesh):
    ei, n = band_graph()
    g = bsda.build_bsda_for_kind(ei, n, kind, depth=3, a_dtype="int8",
                                 transpose=False)
    g = bsda.pad_bsda_chunks(g, mesh.size)
    sg = shardmap_step.partition_bsda(g, mesh.size, use_kernel=kind != "gat")
    return shardmap_step.shard_slice(sg, mesh.rank, mesh.group), g


def job_agg(root: str, mesh, kind: str, feat: int = 16) -> None:
    """sharded_bsda_spmm of this rank's rows and the gradient of
    sum(out * w) with respect to them."""
    sg, g = _sharded(kind, mesh)
    n_loc = sg.a.shape[1] * sg.chunk
    x, w = agg_inputs(g.num_chunks * g.chunk, feat)
    xl = torch.tensor(x[mesh.rank * n_loc: (mesh.rank + 1) * n_loc], requires_grad=True)
    out = shardmap_step.sharded_bsda_spmm(sg, xl)
    (out * torch.from_numpy(w)).sum().backward()
    np.savez(os.path.join(root, f"agg_{kind}_r{mesh.rank}.npz"),
             out=out.detach().numpy(), grad=xl.grad.numpy())


def job_gat(root: str, mesh) -> None:
    """sharded_gat_attend of this rank's rows twice: a forward alone
    (`out_first`), then one with the gradients of sum(out * w) with respect
    to x_proj, a_src and a_dst. The first call holds the process's first
    exp after the aggregation jobs' einsums, which torch's CPU build may
    compute less exactly (tests/torch_exp_spread.py); the test gives it a
    tolerance of its own."""
    sg, g = _sharded("gat", mesh)
    n_loc = sg.a.shape[1] * sg.chunk
    rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
    xp, a_s, a_d, w = gat_inputs(g.num_chunks * g.chunk)
    ts = [torch.tensor(v[rows], requires_grad=True) for v in (xp, a_s, a_d)]
    first = shardmap_step.sharded_gat_attend(sg, *[t.detach() for t in ts])
    out = shardmap_step.sharded_gat_attend(sg, *ts)
    (out * torch.from_numpy(w)).sum().backward()
    np.savez(os.path.join(root, f"gat_r{mesh.rank}.npz"), out_first=first.numpy(),
             out=out.detach().numpy(), d_xp=ts[0].grad.numpy(),
             d_src=ts[1].grad.numpy(), d_dst=ts[2].grad.numpy())


def job_step(root: str, mesh, cfg: dict, init_path: str) -> None:
    """One sage_resbn training step of the halo path from the JAX model's
    weights, dropout 0: the loss and every gradient after their
    all-reduce, before the clip and Adam (an optimizer of rate 0)."""
    from elliptic_gnn_tpu_torch.train import train_gnn

    data = train_gnn.prepare_data(cfg)
    data, model, gops, _, _ = train_gnn.build_train_state(
        cfg, data, cfg["seed"], mesh.device, _load_init(init_path))
    sg, inputs = train_gnn._shard(cfg, data, gops, mesh)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = train_gnn._sharded_step(model, sg, opt, inputs, None, 0.0, False, mesh)
    loss, _ = step()
    if mesh.rank == 0:
        np.savez(os.path.join(root, f"step_n{mesh.size}.npz"), loss=loss.numpy(),
                 **{k: p.grad.numpy() for k, p in model.named_parameters()})


def _load_init(path):
    if path is None:
        return None
    with open(path, "rb") as fh:
        return pickle.load(fh)


def job_main(root: str, mesh, cfg: dict, init_path=None) -> None:
    """train_gnn.main on this rank (its process group is up), from the
    pickled JAX weights at `init_path` where given, each rank writing under
    its own output_root: the run dir must appear under rank 0's alone. Each
    rank's metrics go to a json beside it."""
    from elliptic_gnn_tpu_torch.train import train_gnn

    cfg = dict(cfg, output_root=os.path.join(cfg["output_root"], f"rank{mesh.rank}"))
    metrics = train_gnn.main(cfg, init_params=_load_init(init_path))
    with open(os.path.join(root, f"main_{cfg['run_name']}_r{mesh.rank}.json"), "w") as fh:
        json.dump({"epochs_run": metrics["epochs_run"],
                   "pr_auc_illicit": metrics["pr_auc_illicit"],
                   "best_val_pr_auc": metrics["best_val_pr_auc"]}, fh)


JOBS = {"agg": job_agg, "gat": job_gat, "step": job_step, "main": job_main}


def run_jobs(root: str, jobs: list) -> None:
    """Every job of `jobs` ((name, kwargs) pairs) in this rank, in order."""
    sys.modules["torch.utils.tensorboard"] = None  # CSV-only RunLogger
    multihost.maybe_initialize({}, "cpu")
    mesh = make_mesh(None, "cpu")
    for name, kwargs in jobs:
        JOBS[name](root, mesh, **kwargs)
