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

from elliptic_gnn_tpu_torch import kernels
from elliptic_gnn_tpu_torch.kernels import bsda
from elliptic_gnn_tpu_torch.kernels.ell import build_ell_graph
from elliptic_gnn_tpu_torch.parallel import gspmd_step, multihost, sharded, shardmap_step
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


def gspmd_encoding(kind: str, n_dev: int, rank: int, group=None):
    """Rank `rank`'s GSPMD encoding of band_graph(): 'sage' and 'gcn' the
    int8 BSDA tables with transposes (padded to tile the ranks), 'ell' the
    SAGE mean ELL graph extended and padded as the JAX package pads it."""
    ei, n = band_graph()
    if kind == "ell":
        g = build_ell_graph(ei, n, mean=True)
        n_rows = -(-n // n_dev) * n_dev
        g_sh = sharded.shard_ell_graph(sharded._extend_for_padding(g, n_rows),
                                       cpu_mesh(n_dev, rank))
        return gspmd_step.row_sharded_ell(g_sh, n_dev, rank, group)
    g = bsda.build_bsda_for_kind(ei, n, kind, depth=3, a_dtype="int8", transpose=True)
    return gspmd_step.row_sharded_bsda(bsda.pad_bsda_chunks(g, n_dev), n_dev, rank, group)


def cpu_mesh(n_dev: int, rank: int):
    """A Mesh value of n_dev CPU ranks seen from `rank` (no process group)."""
    from elliptic_gnn_tpu_torch.parallel.mesh import Mesh

    return Mesh(size=n_dev, rank=rank, device=torch.device("cpu"))


def job_gspmd_agg(root: str, mesh, kind: str, feat: int = 16) -> None:
    """kernels.spmm of this rank's rows on its GSPMD encoding (the
    all-gather, then the rectangular dense part and spill, or the ELL
    gather) and the gradient of sum(out * w) with respect to them."""
    rs = gspmd_encoding(kind, mesh.size, mesh.rank, mesh.group)
    x, w = agg_inputs(rs.n_rows, feat)
    rows = slice(mesh.rank * rs.n_loc, (mesh.rank + 1) * rs.n_loc)
    xl = torch.tensor(x[rows], requires_grad=True)
    out = kernels.spmm(rs, xl)
    (out * torch.from_numpy(w)).sum().backward()
    np.savez(os.path.join(root, f"gspmd_{kind}_r{mesh.rank}.npz"),
             out=out.detach().numpy(), grad=xl.grad.numpy())


def job_gspmd_step(root: str, mesh, cfg: dict, init_path: str, tag: str) -> None:
    """One training step of the GSPMD path (the config's arch and pinned
    aggregation) from the JAX model's weights, dropout 0, with the
    config's clip and Adam: the loss, then every parameter and BatchNorm
    buffer after the step."""
    from elliptic_gnn_tpu_torch.train import train_gnn

    data = train_gnn.prepare_data(cfg)
    data, model, gops, opt, _ = train_gnn.build_train_state(
        cfg, data, cfg["seed"], mesh.device, _load_init(init_path))
    rs, inputs = train_gnn._shard(cfg, data, gops, mesh)
    step = train_gnn._sharded_step(model, rs, opt, inputs, None,
                                   float(cfg["grad_clip"]), False, mesh)
    loss, _ = step()
    if mesh.rank == 0:
        np.savez(os.path.join(root, f"gspmd_step_{tag}_n{mesh.size}.npz"),
                 loss=loss.numpy(), **{k: v.numpy() for k, v in model.state_dict().items()})


def job_fallback(root: str, mesh, cfg: dict) -> None:
    """train_gnn.main with partition_bsda (the name the trainer calls)
    rejecting every graph: under `aggregation: auto` the run falls back to
    the GSPMD row sharding and says so; under an explicit `shard_map` it
    raises the ValueError. Writes this rank's metrics, whether the
    fallback line was printed, and the error of the explicit run."""
    import contextlib
    import io

    from elliptic_gnn_tpu_torch.train import train_gnn

    def reject(*args, **kwargs):
        raise ValueError("synthetic non-banded rejection (test)")

    saved = train_gnn.partition_bsda
    train_gnn.partition_bsda = reject
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            metrics = train_gnn.main(dict(cfg, output_root=os.path.join(
                cfg["output_root"], f"rank{mesh.rank}")))
        try:
            train_gnn.main(dict(cfg, run_name=cfg["run_name"] + "_x",
                                aggregation="shard_map", output_root=os.path.join(
                                    cfg["output_root"], f"rank{mesh.rank}")))
            error = None
        except ValueError as exc:
            error = str(exc)
    finally:
        train_gnn.partition_bsda = saved
    with open(os.path.join(root, f"fallback_r{mesh.rank}.json"), "w") as fh:
        json.dump({"fell_back": "falling back to GSPMD einsum" in buf.getvalue(),
                   "error": error,
                   "pr_auc_illicit": metrics["pr_auc_illicit"],
                   "best_val_pr_auc": metrics["best_val_pr_auc"]}, fh)


JOBS = {"agg": job_agg, "gat": job_gat, "step": job_step, "main": job_main,
        "gspmd_agg": job_gspmd_agg, "gspmd_step": job_gspmd_step,
        "fallback": job_fallback}


def run_jobs(root: str, jobs: list) -> None:
    """Every job of `jobs` ((name, kwargs) pairs) in this rank, in order."""
    sys.modules["torch.utils.tensorboard"] = None  # CSV-only RunLogger
    multihost.maybe_initialize({}, "cpu")
    mesh = make_mesh(None, "cpu")
    for name, kwargs in jobs:
        JOBS[name](root, mesh, **kwargs)
