"""Full-batch GNN trainer (port of elliptic_gnn_tpu/train/train_gnn.py).

    python -m elliptic_gnn_tpu_torch.train.train_gnn --config configs/rec_k8.yaml

Same YAML keys and the same `outputs/gnn/<run>` artifacts (metrics.json,
scores_*.npy, y_*.npy, node_idx_*.npy, timestep_*.npy, config_used.yaml,
training_log.csv, best.ckpt, resume.ckpt with `checkpoint_every`,
metrics_hub_removed.json with `ablate_hubs_frac`) as the JAX trainer. Each
epoch: forward over the full graph through the BSDA tables (the CUDA
kernels on the GPU: the SpMM for GCN, SAGE and the SAGE-ResBN family, the
flash attention for GAT), masked loss on train nodes, backward (the SpMM on
the transpose tables; for GAT the one-sweep backward kernel on the forward
tables or, with EGNN_GAT_ONE_SWEEP=0 or
torch.use_deterministic_algorithms(True), the bit-reproducible two-sweep
pair), grad clip, Adam with L2, then an eval forward for the val
probabilities.

Two loops make the same per-epoch decisions (early stop on val PR-AUC with
`patience`, best-model tracking):
  - serial (`epochs_per_sync: 1`): the val probabilities and the loss come
    back to the host in one copy per epoch; the host processes epoch e
    while epoch e+1 runs on the device, so early stopping lags one epoch;
  - K-epoch (`epochs_per_sync: K > 1`; `auto` is K = 8 on CUDA and 1 on the
    CPU): val PR-AUC (tie-exact, utils/metrics.py pr_auc_illicit_device),
    best tracking and patience run on the device, and the host reads one
    [3, K] report per block of K epochs. On CUDA the first epoch runs
    eagerly (it also builds the kernels), then one epoch is captured as a
    CUDA graph and replayed; a capture that fails raises. On the CPU the
    same epoch body runs eagerly.

The encoding follows `aggregation` as in the JAX trainer
(_pick_aggregation): the BSDA tables and the hand-written kernels by
default, or the ELL gather (`aggregation: ell`, relabelled by
renumber_for_ell unless `renumber: false`); `mini_batch: true` trains on
sampled subgraphs (train/sampler.py) and scores the full graph through the
ELL encoding. `profile_dir` traces, with torch.profiler into a Chrome
trace JSON, three blocks of the K loop after the capture (blocks 4-6), or
epochs 4-6 of the serial loop, and writes the recorder's spans beside it.

Spans and counters (utils/trace.py): `setup.prepare` (prepare_data),
`setup.build` (build_train_state) around `setup.order` (the BFS or the ELL
relabelling), `setup.tables` (the encoding and its upload) and
`setup.model` (model, optimizer, loss); in the K loop one `loop.block` a
block around `loop.launch` (with `loop.capture` in a call's first block on
CUDA), `loop.sync` and `loop.tail`; counter `loop_calls`.

Multi-device training: `mesh_devices: N` (or `all`) splits the node rows
over N ranks of a torch.distributed group (NCCL on CUDA, gloo under
`device: cpu`), one process per rank. Without the EGNN_* variables (or
config keys) of parallel/multihost.py, main() starts the N ranks on this
host itself and returns rank 0's metrics; with them, this process is one
rank (train_rank). Two routes, as in the JAX trainer:
  - the explicit halo path (parallel/shardmap_step.py), what `aggregation:
    auto` is on a mesh: the destination chunks split over the ranks, each
    rank's aggregation through the BSDA kernel on its split tables after a
    ring exchange of the boundary rows (GAT through the GAT kernels'
    rectangular launch over the shard's halo-extended rows);
    `aggregation: shard_map` at `mesh_devices: 1` runs it in a world of
    one;
  - the GSPMD row sharding (parallel/gspmd_step.py), for a pinned
    `aggregation: bsda|bsda_pallas|ell` on a mesh, and for `auto` where
    partition_bsda finds the graph not banded enough (the tables are then
    rebuilt with transpose tables): the rows all-gathered, each rank's
    destination rows through the kernel's rectangular launch (GAT: the GAT
    kernels' rectangular launch; ELL: the gather).
BatchNorm statistics and the loss are all-reduced, the gradients
all-reduced as one flat buffer before the clip and Adam; every rank takes
the same decisions, and the primary rank alone writes the run dir.
`mini_batch` trains on one device.

Runs on CUDA (`device: auto` or `cuda`) and raises when there is no GPU,
unless the config says `device: cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import yaml

from ..graph import load_processed, make_temporal_masks
from ..graph.transform import append_scalar_time, remove_hub_edges, symmetrize_edges
from ..kernels import bsda_spmm_cuda, gat_cuda
from ..kernels.bsda import BsdaGraph, bfs_order, build_bsda_for_kind, pad_bsda_chunks
from ..kernels.ell import EllGraph, renumber_for_ell
from ..kernels.packed_gat import use_two_sweep_backward
from ..models import MODEL_GRAPH_KIND, build_model, prepare_graph_ops
from ..models.convert import params_from_jax
from ..models.losses import class_weights, make_loss_fn, make_loss_parts
from ..parallel import multihost
from ..parallel.mesh import NODE_AXIS, check_devices, make_mesh
from ..parallel.sharded import shard_graph_inputs
from ..parallel.shardmap_step import partition_bsda, shard_slice
from ..utils import metrics as M
from ..utils import trace
from ..utils.common import (
    ensure_dir, log_device_info, resolve_device, save_json, set_seed, upload,
)
from ..utils.logger import NullLogger, RunLogger
from . import calibrate, checkpoint


def mesh_size(cfg: dict, device_type: Optional[str] = None) -> int:
    """`mesh_devices`: an integer, or `all`: every rank of an initialized
    multi-process group, else every card of this host (1 on the CPU).
    `device_type` None reads CUDA where a card is present."""
    mesh_cfg = cfg.get("mesh_devices", 1) or 1
    if mesh_cfg != "all":
        return int(mesh_cfg)
    if multihost.process_count() > 1:
        return multihost.process_count()
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.cuda.device_count() if device_type == "cuda" else 1


def _kind(cfg: dict) -> str:
    arch = cfg["arch"]
    if arch not in MODEL_GRAPH_KIND:
        raise ValueError(
            f"Unknown arch {arch!r}; expected one of {sorted(MODEL_GRAPH_KIND)}"
        )
    return MODEL_GRAPH_KIND[arch]


def _pick_aggregation(cfg: dict, kind: str, n_mesh: Optional[int] = None) -> str:
    """The aggregation encoding, by the JAX trainer's table:
      'shard_map'            the explicit halo path over the ranks of a
                             mesh: what 'auto' is on a mesh of more than
                             one rank (`n_mesh`; None reads mesh_devices)
      'bsda', 'bsda_pallas'  the int8 BSDA tables; on CUDA tensors through
                             the hand-written kernels, on CPU tensors
                             through their plain versions (the two names
                             are one path in the port; 'auto' is 'bsda',
                             and GAT's 'bsda_pallas' is 'bsda', as in JAX)
      'ell'                  the ELL gather (kernels/ell.py); always for
                             `mini_batch`
    On a mesh of more than one rank a pinned 'bsda', 'bsda_pallas' or
    'ell' takes the GSPMD row sharding (_shard). Unknown values raise."""
    mode = cfg.get("aggregation", "auto")
    if cfg.get("use_pallas", False):  # the JAX package's legacy switch
        mode = "bsda_pallas"
    if cfg.get("mini_batch", False) or kind not in ("sage", "gcn", "gat"):
        return "ell"
    if mode == "auto":
        if (mesh_size(cfg) if n_mesh is None else n_mesh) > 1:
            return "shard_map"
        return "bsda"
    if mode == "bsda_pallas":
        return "bsda" if kind == "gat" else "bsda_pallas"
    if mode not in ("bsda", "ell", "shard_map"):
        raise ValueError(
            f"Unknown aggregation {mode!r}; expected one of "
            "auto/bsda/bsda_pallas/ell/shard_map"
        )
    return str(mode)


def make_optimizer(model: torch.nn.Module, cfg: dict,
                   capturable: bool = False) -> torch.optim.Adam:
    """torch.optim.Adam with L2 weight decay added to the gradient before
    the moments (not AdamW); the epoch step clips the grad norm first.
    `capturable` keeps the step count on the device (CUDA), as a captured
    epoch needs; the trainer sets it for both of its loops on CUDA."""
    return torch.optim.Adam(
        model.parameters(), lr=float(cfg["lr"]), betas=(0.9, 0.999), eps=1e-8,
        weight_decay=float(cfg.get("weight_decay", 0.0)), capturable=capturable)


def epochs_per_sync(cfg: dict, device: torch.device) -> int:
    """K of the K-epoch loop: `auto` is 8 on CUDA and 1 (serial) on the CPU,
    as the JAX trainer takes 8 on its accelerator; an integer pins K and 1
    forces the serial loop."""
    k_cfg = cfg.get("epochs_per_sync", "auto")
    if k_cfg not in (None, "auto"):
        return int(k_cfg) or 1
    return 8 if device.type == "cuda" else 1


def prepare_data(cfg: dict):
    """Load the processed graph and apply the preprocessing pipeline:
    rolling window re-mask, scalar-time append, symmetrization."""
    with trace.span("setup.prepare"):
        data = load_processed(cfg["processed_dir"])
        if data.train_mask is None:
            raise RuntimeError(
                "Build graph first: python -m elliptic_gnn_tpu_torch.graph.build_graph "
                "--config configs/split.yaml"
            )

        window_k = cfg.get("train_window_k")
        if window_k is not None:
            train_ts = data.timestep[data.train_mask]
            if train_ts.size == 0:
                raise RuntimeError("Train mask is empty; cannot apply rolling window.")
            val_ts = data.timestep[data.val_mask]
            if val_ts.size == 0:
                raise RuntimeError("Validation mask is empty; cannot infer t_val_end.")
            data = make_temporal_masks(
                data, int(train_ts.max()), int(val_ts.max()), int(window_k)
            )

        if cfg.get("use_time_scalar", False) and int(cfg.get("time_embed_dim", 0) or 0) == 0:
            data = append_scalar_time(data)

        if cfg.get("symmetrize_edges", False):
            data = symmetrize_edges(data)
        return data


def build_tables(cfg: dict, edge_index: np.ndarray, num_nodes: int,
                 device: torch.device, transpose: bool):
    """The int8 BSDA tables of the arch's graph kind on `device`: depth 3
    for sage/gcn, 4 for gat (`bsda_depth` overrides)."""
    kind = MODEL_GRAPH_KIND[cfg["arch"]]
    return build_bsda_for_kind(
        edge_index, num_nodes, kind,
        depth=int(cfg.get("bsda_depth", 4 if kind == "gat" else 3)),
        a_dtype="int8", transpose=transpose,
    ).to(device)


def build_graph_ops(cfg: dict, data, device: torch.device,
                    training: bool = True):
    """(data, gops): the graph and its aggregation encoding on `device`,
    chosen by _pick_aggregation; the one place that picks it (the trainer,
    predict and the post-hoc tools' rebuild_on come here).

    BSDA: the graph BFS-renumbered and its int8 tables, as the JAX trainer
    builds them for its kernel paths: with transpose tables for sage/gcn
    (gradients run the SpMM on A^T); gat's one-sweep backward walks the
    forward tables, its transpose tables are built only for `training` with
    the two-sweep backward chosen
    (kernels/packed_gat.py::use_two_sweep_backward).
    ELL: models.prepare_graph_ops, relabelled by renumber_for_ell unless
    `renumber: false` or `mini_batch` (the sampler keeps on-disk ids).
    `aggregation: shard_map` (or `auto` on a mesh) builds the same tables
    without transpose tables (the trainer partitions them; the scoring pass,
    predict and rebuild_on use them whole, on one device).
    A renumbered graph's artifacts translate back via data.orig_index.
    Spans: `setup.order` (the ordering and the relabelled graph) and
    `setup.tables` (the encoding and its upload; ELL's in two parts, around
    its relabelling)."""
    kind = _kind(cfg)
    agg = _pick_aggregation(cfg, kind)
    if agg == "ell":
        with trace.span("setup.tables"):
            gops = prepare_graph_ops(data.edge_index, data.num_nodes, kind)
        if bool(cfg.get("renumber", True)) and not cfg.get("mini_batch", False):
            with trace.span("setup.order"):
                gops, rank = renumber_for_ell(gops)
                data = data.renumber(rank)
        with trace.span("setup.tables"):
            return data, gops.to(device)
    with trace.span("setup.order"):
        rank = bfs_order(data.edge_index, data.num_nodes, data.timestep)
        data = data.renumber(rank)
    with trace.span("setup.tables"):
        gops = build_tables(
            cfg, data.edge_index, data.num_nodes, device,
            transpose=agg != "shard_map" and (
                kind != "gat" or (training and use_two_sweep_backward())))
    return data, gops


def build_train_state(cfg: dict, data, seed: int, device: torch.device,
                      init_params=None):
    """(data, model, gops, optimizer, loss_fn) on `device`. `init_params` =
    (params, state) of a JAX model as numpy pytrees replaces the port's
    own init. Spans: `setup.build` around `setup.order` and
    `setup.tables` (build_graph_ops) and `setup.model`."""
    with trace.span("setup.build", arch=cfg["arch"]):
        data, gops = build_graph_ops(cfg, data, device)
        with trace.span("setup.model"):
            gen = torch.Generator().manual_seed(int(seed))
            model = build_model(cfg["arch"], data.num_features, cfg, generator=gen)
            if init_params is not None:
                params_from_jax(init_params[0], init_params[1], model)
            model = model.to(device)
            opt = make_optimizer(model, cfg, capturable=device.type == "cuda")
            loss_fn = make_loss_fn(cfg, *_loss_args(cfg, data), device)
    return data, model, gops, opt, loss_fn


def _loss_args(cfg: dict, data):
    """(class weights, first and last train timestep) of the loss."""
    if cfg.get("class_weight_pos", "auto") == "auto":
        cw = class_weights(data.y[data.train_mask])
    else:
        cw = np.array([1.0, float(cfg["class_weight_pos"])], dtype=np.float32)
    t_train = data.timestep[data.train_mask]
    return cw, int(t_train.min()), int(t_train.max())


def main(cfg: dict, init_params=None) -> dict:
    """Train one config; returns its metrics (on a mesh started here, rank
    0's, read from its metrics.json)."""
    set_seed(cfg.get("seed", 42))
    device = resolve_device(cfg.get("device", "auto"))
    multihost.maybe_initialize(cfg, device.type)
    n_mesh = 1 if cfg.get("mini_batch", False) else mesh_size(cfg, device.type)
    n_proc = multihost.process_count()
    if n_mesh > 1 and n_proc == 1:
        return _launch_ranks(cfg, n_mesh, device, init_params)
    if n_proc > 1 and n_mesh != n_proc:
        raise ValueError(
            f"multi-process runs must shard over all {n_proc} ranks: set "
            f"mesh_devices: all (got {cfg.get('mesh_devices', 1)})")
    if n_proc > 1 or (not cfg.get("mini_batch", False) and
                      _pick_aggregation(cfg, _kind(cfg), n_mesh) == "shard_map"):
        return train_rank(cfg, init_params, device)
    return _run(cfg, init_params, device, None)


def train_rank(cfg: dict, init_params=None, device: Optional[torch.device] = None) -> dict:
    """One rank's run over the mesh of the process group it is in (a world
    of one where none is up): the function a rank process runs. The route
    follows `aggregation` on the mesh's size (_shard): the halo path, or
    the GSPMD row sharding for a pinned single-device encoding, also on a
    mesh of one."""
    if device is None:
        device = resolve_device(cfg.get("device", "auto"))
    with multihost.world_of_one(device.type):
        mesh = make_mesh(multihost.process_count(), device.type)
        return _run(cfg, init_params, device, mesh)


def _launch_ranks(cfg: dict, n: int, device: torch.device, init_params) -> dict:
    """`mesh_devices: n` without a process group: n ranks on this host, one
    process each (parallel/multihost.py::spawn_ranks); rank 0's metrics."""
    check_devices(n, device.type)
    print(f"[MESH] starting {n} ranks on this host ({device.type})")
    multihost.spawn_ranks(n, main, (cfg, init_params), device.type)
    outdir = os.path.join(cfg.get("output_root", "outputs"), "gnn", cfg["run_name"])
    with open(os.path.join(outdir, "metrics.json")) as fh:
        return json.load(fh)


def _run(cfg: dict, init_params, device: torch.device, mesh) -> dict:
    """One process's run: single-device (`mesh` None) or one rank of a
    mesh (the halo path or the GSPMD row sharding, _shard)."""
    if mesh is not None:
        device = mesh.device
    primary = multihost.is_primary()
    outdir = os.path.join(cfg.get("output_root", "outputs"), "gnn", cfg["run_name"])
    if primary:
        ensure_dir(outdir)
        logger = RunLogger(outdir)
    else:
        logger = NullLogger()
    log_device_info(device)

    data = prepare_data(cfg)
    data, model, gops, opt, loss_fn = build_train_state(
        cfg, data, cfg.get("seed", 42), device, init_params)
    inputs = _Inputs(data, device)
    train_ops, train_inputs = gops, inputs
    if mesh is not None:
        train_ops, train_inputs = _shard(cfg, data, gops, mesh)

    t_start = time.time()
    if cfg.get("mini_batch", False):
        from .sampler import train_loop_minibatch

        best, best_val, epochs_run, epoch_seconds, loop_info = train_loop_minibatch(
            cfg, data, inputs, model, opt, loss_fn, logger, device)
    else:
        best, best_val, epochs_run, epoch_seconds, loop_info = _train_loop_fullbatch(
            cfg, outdir, train_inputs, model, train_ops, opt, loss_fn, logger,
            device, mesh)
    train_seconds = time.time() - t_start
    model.load_state_dict(best)
    if primary:
        checkpoint.save_best(outdir, model)

    return _finalize(cfg, outdir, data, inputs, model, gops, best_val, logger,
                     train_seconds, epochs_run, epoch_seconds, loop_info)


def _shard(cfg: dict, data, gops, mesh):
    """This rank's share of the mesh run: its encoding and its rows of the
    node arrays (_ShardInputs).

    The halo path (`aggregation` shard_map, or auto on a mesh): the tables
    padded to tile the mesh, partitioned (the block transpose for sage/gcn
    and for GAT's two-sweep backward) and sliced to this rank. A graph
    that partition_bsda rejects raises its ValueError under an explicit
    `aggregation: shard_map`; under `auto` the run falls back to the GSPMD
    row sharding, as the JAX trainer does, on tables rebuilt with the JAX
    trainer's fallback depth and transpose tables (GAT: with the two-sweep
    backward only).

    The GSPMD row sharding (a pinned bsda|bsda_pallas|ell): BSDA tables
    padded to tile the mesh, this rank's destination chunks of them and of
    their transpose (gspmd_step.RowShardedBsda); ELL tables extended and
    padded as the JAX package pads them, cut to this rank's rows
    (gspmd_step.RowShardedEll)."""
    kind = _kind(cfg)
    halo = _pick_aggregation(cfg, kind, mesh.size) == "shard_map"
    transpose = kind != "gat" or use_two_sweep_backward()
    if isinstance(gops, BsdaGraph):
        gops = pad_bsda_chunks(gops, mesh.size)
    if halo:
        try:
            sg = partition_bsda(gops, mesh.size, use_kernel=transpose)
        except ValueError as exc:
            if str(cfg.get("aggregation", "auto")) == "shard_map":
                raise
            print(f"[MESH] graph not banded for boundary-only halo exchange ({exc}); "
                  "falling back to GSPMD einsum")
            halo = False
            gops = pad_bsda_chunks(build_bsda_for_kind(
                data.edge_index, data.num_nodes, kind,
                depth=int(cfg.get("bsda_depth", 3)), a_dtype="int8",
                transpose=transpose).to(gops.a.device), mesh.size)
    if halo:
        train_ops = shard_slice(sg, mesh.rank, mesh.group).to(mesh.device)
        arrays = shard_graph_inputs(mesh, data, gops)
    else:
        *arrays, train_ops, n_pad = shard_graph_inputs(mesh, data, gops, shard_tables=True)
        arrays = (*arrays, n_pad)
    inputs = _ShardInputs(cfg, data, arrays, mesh)
    print(f"[MESH] training sharded over {mesh.size} ranks of the {NODE_AXIS!r} axis "
          f"({inputs.n_pad} padded rows, {'explicit shard_map' if halo else 'GSPMD'}), "
          f"rank {mesh.rank} on {mesh.device}")
    return train_ops, inputs


class _Inputs:
    """The graph's node arrays on the device, uploaded once through pinned
    memory; they keep their addresses for the run (a captured epoch reads
    them there)."""

    def __init__(self, data, device: torch.device):
        self.x = upload(data.x, device, torch.float32)
        self.y = upload(np.maximum(data.y, 0).astype(np.int64), device)
        self.t = upload(data.timestep.astype(np.int32), device)
        self.train_mask = upload(data.train_mask.astype(np.float32), device)
        self.val_idx = upload(np.where(data.val_mask)[0], device)
        self.y_val = upload((data.y[data.val_mask] == 1).astype(np.int32), device)


class _ShardInputs:
    """This rank's rows of the node arrays (`arrays`, from
    parallel/sharded.py::shard_graph_inputs), the val rows it owns with
    their positions in the global val vector, the global val labels, the
    global train count (the loss denominator) and the loss's parts."""

    def __init__(self, cfg: dict, data, arrays, mesh):
        (self.x, self.y, self.t, self.train_mask, self.row_mask,
         self.n_pad) = arrays
        n_loc = self.x.shape[0]
        lo = mesh.rank * n_loc
        val_idx = np.where(data.val_mask)[0]
        mine = (val_idx >= lo) & (val_idx < lo + n_loc)
        self.n_val = int(val_idx.size)
        self.val_local = upload(val_idx[mine] - lo, mesh.device)
        self.val_pos = upload(np.nonzero(mine)[0], mesh.device)
        self.y_val = upload((data.y[data.val_mask] == 1).astype(np.int32), mesh.device)
        self.den = torch.tensor(max(float(data.train_mask.sum()), 1.0),
                                dtype=torch.float32, device=mesh.device)
        self.loss_parts = make_loss_parts(cfg, *_loss_args(cfg, data), mesh.device)


def _snapshot(model: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _train_loop_fullbatch(cfg, outdir, inputs, model, gops, opt, loss_fn,
                          logger, device, mesh=None):
    """Returns (best state_dict, best_val, epochs_run, epoch_seconds,
    loop_info): epoch_seconds holds each epoch's host wall time (the serial
    loop: one iteration; the K loop: its block's wall over the epochs the
    block ran, the first block's eager epoch and capture included);
    loop_info the K and, on CUDA, the replays of the captured epoch, the
    kernel launches captured in it (each replay launches them again) and
    replay_ms, per block the device time of one replayed epoch (CUDA events
    around the block's replays), and boundary_ms, per block after the
    first, the device time from the previous block's last replay to its
    first (both read from the blocks' spans). With a `mesh`, `gops` and `inputs` are
    this rank's shard and rows (_shard) and the epoch is the sharded step
    (_sharded_step)."""
    t_idx_arg = inputs.t if model.uses_time_embed else None
    use_time_loss = str(cfg.get("time_loss_weighting", "none")) != "none"
    # each rank draws its own dropout masks: the seed and the rank make its
    # generator's seed (rank 0's is the single-device run's)
    rank = 0 if mesh is None else mesh.rank
    gen = torch.Generator(device=device).manual_seed(
        int(cfg.get("seed", 42)) + 1 + (rank << 32))
    grad_clip = float(cfg.get("grad_clip", 0) or 0)

    def train_step():
        """One epoch on the device: training step, then the eval forward.
        Returns (loss, val probabilities), both on the device."""
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(inputs.x, gops, t_idx_arg, generator=gen)
        loss = loss_fn(model, logits, inputs.y, inputs.t if use_time_loss else None,
                       inputs.train_mask)
        loss.backward()
        if grad_clip > 0:
            torch.nn.utils.clip_grad_norm_(model.parameters(), grad_clip)
        opt.step()
        model.eval()
        with torch.no_grad():
            logits = model(inputs.x, gops, t_idx_arg)
            probs_val = torch.softmax(logits, dim=1)[:, 1][inputs.val_idx]
        return loss.detach(), probs_val

    if mesh is not None:
        train_step = _sharded_step(model, gops, opt, inputs, gen, grad_clip,
                                   use_time_loss, mesh)
    best = _snapshot(model)
    best_val, bad, start_epoch = -1.0, 0, 1
    if cfg.get("resume", False) and checkpoint.has_resume(outdir):
        epoch, best_val, bad, rng = checkpoint.load_resume(outdir, model, opt, cfg, best)
        # a file of the JAX package, or of a run on another device type,
        # holds no state of this generator: it restarts from the seed; the
        # file holds rank 0's, so the other ranks restart theirs too
        if rng is not None and rng.numel() == gen.get_state().numel() and rank == 0:
            gen.set_state(rng)
        start_epoch = epoch + 1
        print(f"[RESUME] from epoch {start_epoch} (best_val={best_val:.4f})")

    k = epochs_per_sync(cfg, device)
    run = _k_loop if k > 1 else _serial_loop
    out = run(cfg, outdir, model, opt, logger, device, gen, train_step, inputs,
              best, best_val, bad, start_epoch, k)
    if mesh is not None:
        out[4]["mesh_devices"] = mesh.size
    return out


def _sharded_step(model, sg, opt, inputs, gen, grad_clip, use_time_loss, mesh):
    """One epoch of one rank on the halo path (counterpart of
    make_shardmap_train_step): the training forward on this rank's rows,
    the loss numerator all-reduced over the global train count, each rank
    backpropagating its own share num_r / den (the parameter penalty on
    rank 0 alone), the gradients all-reduced (SUM) as one flat buffer
    before the clip and Adam, then the eval forward and the val
    probabilities assembled on every rank by an all-reduce. Returns (loss,
    val probabilities) on the device, the same on every rank."""
    loss_vec_fn, penalty_fn = inputs.loss_parts
    group = mesh.group
    params = list(model.parameters())
    t_idx = inputs.t if model.uses_time_embed else None

    def train_step():
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(inputs.x, sg, t_idx, generator=gen,
                       row_mask=inputs.row_mask, group=group)
        vec = loss_vec_fn(logits, inputs.y, inputs.t if use_time_loss else None)
        num_r = (vec * inputs.train_mask).sum()
        share = num_r / inputs.den
        penalty = penalty_fn(model)
        if penalty is not None and mesh.rank == 0:
            share = share + penalty
        share.backward()
        _all_reduce_grads(params, group)
        if grad_clip > 0:
            torch.nn.utils.clip_grad_norm_(params, grad_clip)
        opt.step()
        num = num_r.detach().clone()
        dist.all_reduce(num, group=group)
        loss = num / inputs.den
        if penalty is not None:
            loss = loss + penalty.detach()
        model.eval()
        with torch.no_grad():
            logits = model(inputs.x, sg, t_idx, row_mask=inputs.row_mask, group=group)
            probs = torch.softmax(logits, dim=1)[:, 1]
            probs_val = probs.new_zeros(inputs.n_val).index_copy_(
                0, inputs.val_pos, probs[inputs.val_local])
            dist.all_reduce(probs_val, group=group)
        return loss, probs_val

    return train_step


def _all_reduce_grads(params, group) -> None:
    """Every parameter's gradient summed over the group, in one all-reduce
    of a flat buffer (a parameter without a gradient counts zeros)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    off = 0
    for p, g in zip(params, grads):
        chunk = flat[off: off + g.numel()].view_as(g)
        off += g.numel()
        if p.grad is None:
            p.grad = chunk.clone()
        else:
            p.grad.copy_(chunk)


def _serial_loop(cfg, outdir, model, opt, logger, device, gen, train_step, inputs,
                 best, best_val, bad, start_epoch, k):
    y_val_bin = inputs.y_val.cpu().numpy()
    patience = int(cfg.get("patience", 20))
    ckpt_every = int(cfg.get("checkpoint_every", 0) or 0)
    epochs_run = 0
    epoch_seconds = []

    def epoch_step(ep):
        loss, probs_val = train_step()
        fused = torch.cat([probs_val, loss[None]])
        # a checkpoint epoch keeps the optimizer and generator too: the host
        # saves it one epoch later, when the model has moved on
        saved = None
        if ckpt_every and ep % ckpt_every == 0:
            saved = (_snapshot_opt(opt), gen.get_state())
        return ep, fused, _snapshot(model), saved

    def process(ep, fused_dev, state_e, saved) -> bool:
        """Host tail of one epoch: pull the fused vector (the one sync),
        val PR-AUC, best tracking, checkpoint, early-stop decision."""
        nonlocal best_val, bad, best, epochs_run
        fused_h = multihost.replicate_to_all_hosts(fused_dev).cpu().numpy()
        p_val, loss_f = fused_h[:-1], float(fused_h[-1])
        pr_val = 0.0 if p_val.size == 0 else M.pr_auc_illicit(y_val_bin, p_val)
        logger.log_epoch(ep, loss_f, pr_val)
        epochs_run += 1
        if pr_val > best_val:
            best_val, best, bad = pr_val, state_e, 0
        else:
            bad += 1
        if ep % 10 == 0 or ep == 1:
            print(f"Epoch {ep:4d} | loss {loss_f:.4f} | "
                  f"val PR-AUC(illicit) {pr_val:.4f} (best {best_val:.4f})")
        if saved is not None and multihost.is_primary():
            checkpoint.save_resume(outdir, model, saved[0], cfg, ep, best_val, bad,
                                   best=best, rng_state=saved[1], current=state_e)
        if bad >= patience:
            print("Early stopping.")
            return True
        return False

    # process the PREVIOUS epoch while this one runs on the device: the
    # early-stop check lags one epoch (one discarded in-flight epoch at stop)
    # the trace is the primary rank's, as all artifact IO
    profile_dir = cfg.get("profile_dir") if multihost.is_primary() else None
    prof = None
    pending = None
    try:
        for epoch in range(start_epoch, int(cfg["max_epochs"]) + 1):
            if profile_dir and epoch == start_epoch + 3:
                prof = _start_trace(device)
            t0 = time.time()
            step = epoch_step(epoch)
            if prof is not None and epoch == start_epoch + 5:
                _stop_trace(prof, profile_dir, cfg["run_name"], device)
                prof = None
            stop = pending is not None and process(*pending)
            epoch_seconds.append(time.time() - t0)
            if stop:
                pending = None
                break
            pending = step
        if pending is not None:
            process(*pending)
    finally:
        if prof is not None:  # the run ended inside the traced epochs
            _stop_trace(prof, profile_dir, cfg["run_name"], device)
    return best, best_val, epochs_run, epoch_seconds, {"epochs_per_sync": 1}


def _start_trace(device: torch.device):
    """A started torch.profiler (CPU, and CUDA on the card), or None where
    it fails to start: profiling is best effort and the run goes on, as in
    the JAX trainer."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.start()
    except Exception as exc:
        print(f"[PROFILE] start_trace failed: {exc}")
        return None
    return prof


def _stop_trace(prof, profile_dir: str, run_name: str,
                device: torch.device) -> None:
    """Stop the trace once the traced epochs have run on the device and
    write it as <profile_dir>/<run_name>.trace.json (Chrome trace format,
    where the JAX trainer writes TensorBoard's profile layout), the
    recorder's spans beside it as <run_name>.spans.json; a failure prints
    and the run goes on."""
    try:
        if device.type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"{run_name}.trace.json")
        prof.export_chrome_trace(path)
        trace.write(os.path.join(profile_dir, f"{run_name}.spans.json"))
        print(f"[PROFILE] trace written to {path}")
    except Exception as exc:
        print(f"[PROFILE] stop_trace failed: {exc}")


# the K loop's blocks that `profile_dir` traces: the fourth to the sixth
PROFILE_FROM_BLOCK = 3
PROFILE_BLOCKS = 3


def _snapshot_opt(opt: torch.optim.Adam) -> dict:
    """A copy of torch Adam's per-parameter state."""
    return {p: {k: v.detach().clone() for k, v in st.items()}
            for p, st in opt.state.items()}


class _DeviceLoop:
    """The epoch body of the K-epoch loop: `train_step`, then the val
    PR-AUC, best tracking and patience on the device, and the epoch's
    report (loss, PR-AUC, ran) written into column `slot` of a [3, K]
    buffer. Once patience is spent (`active` false) an epoch still trains,
    but changes neither the best model, best_val, the patience count nor
    the report (its column stays 0): the counterpart of the JAX loop's
    lax.cond. Every tensor it touches keeps its address, so the body can be
    captured as one CUDA graph and replayed."""

    def __init__(self, model, train_step, y_val, patience: int, k: int,
                 best: dict, best_val: float, bad: int, device):
        self.train_step = train_step
        self.y_val = y_val
        self.patience = patience
        state = model.state_dict()
        self.pairs = [(state[name], best[name]) for name in best]
        self.bval = torch.tensor(best_val, dtype=torch.float32, device=device)
        self.bad = torch.tensor(bad, dtype=torch.int32, device=device)
        self.report = torch.zeros((3, k), dtype=torch.float32, device=device)
        self.slot = torch.zeros(1, dtype=torch.int64, device=device)

    def body(self) -> None:
        active = self.bad < self.patience
        loss, probs_val = self.train_step()
        pr = M.pr_auc_illicit_device(self.y_val, probs_val)
        improved = active & (pr > self.bval)
        self.bval.copy_(torch.where(improved, pr, self.bval))
        self.bad.copy_(torch.where(active, torch.where(improved, 0, self.bad + 1),
                                   self.bad))
        with torch.no_grad():
            for cur, kept in self.pairs:
                kept.copy_(torch.where(improved, cur, kept))
        row = torch.stack([loss.float(), pr, torch.ones_like(pr)])
        self.report.index_copy_(1, self.slot, torch.where(active, row, 0.0)[:, None])
        self.slot.add_(1)


def _count_launches() -> dict:
    return {**bsda_spmm_cuda.launches, **gat_cuda.launches}


def _first_epoch_and_capture(loop: _DeviceLoop, gen: torch.Generator):
    """The K loop's first epoch eagerly, on a side stream as the capture
    will run (a real epoch that also builds the kernels), then the capture,
    which runs nothing: span `loop.capture`, its attrs the launches
    captured. Returns _capture's (graph, launches)."""
    with trace.span("loop.capture") as cap:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            loop.body()
        torch.cuda.current_stream().wait_stream(side)
        graph, captured = _capture(loop, gen)
        cap.attrs.update(captured)
    return graph, captured


def _capture(loop: _DeviceLoop, gen: torch.Generator):
    """loop.body as one CUDA graph (the dropout generator registered with
    it, so that each replay draws the next epoch's masks). Returns (graph,
    kernel launches recorded in it); a failed capture raises."""
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    before = _count_launches()
    try:
        with torch.cuda.graph(graph):
            loop.body()
    except Exception as exc:
        raise RuntimeError(
            f"capturing the training epoch as a CUDA graph failed: {exc}; "
            "epochs_per_sync: 1 runs the serial loop") from exc
    after = _count_launches()
    return graph, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _k_loop(cfg, outdir, model, opt, logger, device, gen, train_step, inputs,
            best, best_val, bad, start_epoch, k):
    """Blocks of K epochs with one host read each (see _DeviceLoop); the
    host then logs, prints and decides as the serial loop does, with the
    device-computed PR-AUC. Checkpoints land on the block boundaries that
    cross a multiple of `checkpoint_every`, never after a stop.

    Each block is a `loop.block` span (attrs `call`, the loop's call in this
    process; `block`; `epochs`; on CUDA `replays`, `replay_ms`, the device
    ms of one replayed epoch, and `boundary_ms`, the device ms from the
    previous block's last replay to this block's first) around `loop.launch`
    (the report's zero_, the events, the replays' enqueue; in the call's
    first block on CUDA `loop.capture`, the eager epoch and the capture),
    `loop.sync` (the report's readback) and `loop.tail` (logging,
    decisions, prints, checkpoint). `profile_dir` traces blocks
    PROFILE_FROM_BLOCK on, PROFILE_BLOCKS of them, started and stopped at
    block boundaries."""
    patience = int(cfg.get("patience", 20))
    ckpt_every = int(cfg.get("checkpoint_every", 0) or 0)
    max_ep = int(cfg["max_epochs"])
    # the host repeats the device's decisions on the same f32 values
    best_val = float(np.float32(best_val))
    loop = _DeviceLoop(model, train_step, inputs.y_val, patience, k, best,
                       best_val, bad, device)
    call = trace.count("loop_calls")
    # the trace is the primary rank's, as all artifact IO
    profile_dir = cfg.get("profile_dir") if multihost.is_primary() else None
    prof = None
    graph, captured, replays, blocks, prev_end = None, {}, 0, [], None
    epochs_run, epoch_seconds = 0, []
    ep, stopped = start_epoch, False
    try:
        while ep <= max_ep and not stopped:
            if profile_dir and len(blocks) == PROFILE_FROM_BLOCK:
                prof = _start_trace(device)
            block_start = ep
            n = min(k, max_ep - ep + 1)
            t0 = time.time()
            with trace.span("loop.block", call=call, block=len(blocks), epochs=n) as blk:
                blocks.append(blk)
                todo = 0
                with trace.span("loop.launch"):
                    loop.slot.zero_()
                    loop.report.zero_()
                    if device.type != "cuda":
                        for _ in range(n):
                            loop.body()
                    else:
                        todo = n
                        if graph is None:
                            graph, captured = _first_epoch_and_capture(loop, gen)
                            todo -= 1
                        if todo:
                            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                            events[0].record()
                            for _ in range(todo):
                                graph.replay()
                            events[1].record()
                        replays += todo
                # the block's one host sync
                with trace.span("loop.sync"):
                    rh = multihost.replicate_to_all_hosts(loop.report).cpu().numpy()
                    if todo:
                        blk.attrs.update(replays=todo,
                                         replay_ms=events[0].elapsed_time(events[1]) / todo)
                        if prev_end is not None:
                            blk.attrs["boundary_ms"] = prev_end.elapsed_time(events[0])
                        prev_end = events[1]
                wall = time.time() - t0
                with trace.span("loop.tail"):
                    losses, prs, ran = rh[0], rh[1], rh[2] > 0.5
                    for i in range(n):
                        if not ran[i]:  # the device spent its patience: it ran no more
                            stopped = True
                            break
                        loss_f, pr_val = float(losses[i]), float(prs[i])
                        logger.log_epoch(ep, loss_f, pr_val)
                        epochs_run += 1
                        epoch_seconds.append(wall / n)
                        if pr_val > best_val:
                            best_val, bad = pr_val, 0
                        else:
                            bad += 1
                        if ep % 10 == 0 or ep == start_epoch:
                            print(f"Epoch {ep:4d} | loss {loss_f:.4f} | "
                                  f"val PR-AUC(illicit) {pr_val:.4f} (best {best_val:.4f})")
                        ep += 1
                        if bad >= patience:
                            print("Early stopping.")
                            stopped = True
                            break
                    if (ckpt_every and not stopped and multihost.is_primary()
                            and (ep - 1) // ckpt_every > (block_start - 1) // ckpt_every):
                        checkpoint.save_resume(outdir, model, opt.state, cfg, ep - 1, best_val,
                                               bad, best=best, rng_state=gen.get_state())
            if prof is not None and len(blocks) == PROFILE_FROM_BLOCK + PROFILE_BLOCKS:
                _stop_trace(prof, profile_dir, cfg["run_name"], device)
                prof = None
    finally:
        if prof is not None:  # the run ended inside the traced blocks
            _stop_trace(prof, profile_dir, cfg["run_name"], device)
    info = {"epochs_per_sync": k}
    if device.type == "cuda":
        info.update(graph_replays=replays, graph_launches=captured,
                    replay_ms=[b.attrs["replay_ms"] for b in blocks if "replay_ms" in b.attrs],
                    boundary_ms=[b.attrs["boundary_ms"] for b in blocks
                                 if "boundary_ms" in b.attrs])
    return best, best_val, epochs_run, epoch_seconds, info


def _finalize(cfg, outdir, data, inputs, model, gops, best_val, logger,
              train_seconds: float, epochs_run: int, epoch_seconds,
              loop_info: dict) -> dict:
    """Full-graph eval with the best parameters, temperature scaling,
    artifacts, threshold + metrics, optional hub ablation, config echo. A
    rank of a sharded run scores the whole graph with the single-device
    encoding (`gops`), as the JAX trainer does per host; the primary rank
    writes, then every rank passes a barrier."""
    t_idx_arg = inputs.t if model.uses_time_embed else None
    model.eval()
    with torch.no_grad():
        logits_full = model(inputs.x, gops, t_idx_arg).cpu().numpy()
    y_val_bin = (data.y[data.val_mask] == 1).astype(int)

    temp = 1.0
    if bool(cfg.get("calibrate_temperature", True)):
        temp = calibrate.fit_temperature(logits_full[data.val_mask], y_val_bin)
        print(f"[CALIB] temperature T={temp:.4f}")

    primary = multihost.is_primary()
    probs = calibrate.calibrated_probs(logits_full, temp)
    metrics = finish_run(cfg, outdir, data, probs, best_val, write=primary, extra={
        "train_seconds": float(train_seconds),
        "epochs_run": int(epochs_run),
        "epoch_seconds": [float(s) for s in epoch_seconds],
        "edges_per_s": float(data.num_edges) * epochs_run / max(train_seconds, 1e-9),
        "temperature": float(temp),
        **loop_info,
    })

    frac = float(cfg.get("ablate_hubs_frac", 0.0) or 0.0)
    if frac > 0:
        # the run's encoding again on the (renumbered) graph without the hub
        # edges, scored by the best model the same way
        ei_abl, num_hubs = remove_hub_edges(data.edge_index, data.num_nodes, frac)
        if isinstance(gops, EllGraph):
            gops_abl = prepare_graph_ops(
                ei_abl, data.num_nodes, MODEL_GRAPH_KIND[cfg["arch"]]
            ).to(inputs.x.device)
        else:
            gops_abl = build_tables(cfg, ei_abl, data.num_nodes, inputs.x.device,
                                    transpose=False)
        with torch.no_grad():
            logits_abl = model(inputs.x, gops_abl, t_idx_arg).cpu().numpy()
        p_abl = calibrate.calibrated_probs(logits_abl, temp)
        y_te = data.y[data.test_mask]
        hub_metrics = test_metrics_at_threshold(
            cfg, (y_te == 1).astype(int), p_abl[data.test_mask], metrics["threshold"])
        hub_metrics.update(n_hubs=int(num_hubs), hub_fraction=frac,
                           n_edges_remaining=int(ei_abl.shape[1]))
        if primary:
            save_json(os.path.join(outdir, "metrics_hub_removed.json"), hub_metrics)

    if primary:
        with open(os.path.join(outdir, "config_used.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
        print(json.dumps(metrics, indent=2))
    logger.close()
    multihost.barrier("finalize")  # every rank leaves the run together
    return metrics


def test_metrics_at_threshold(cfg: dict, y_bin: np.ndarray, p_te: np.ndarray,
                              thr: float) -> dict:
    """The standard test-metric block at a fixed threshold."""
    return dict(
        pr_auc_illicit=M.pr_auc_illicit(y_bin, p_te),
        roc_auc=M.roc_auc_illicit(y_bin, p_te),
        f1_illicit_at_thr=M.f1_at_threshold(y_bin, p_te, thr),
        threshold=float(thr),
        precision_at_k=M.precision_at_k(y_bin, p_te, int(cfg.get("topk", 100))),
        recall_at_precision=M.recall_at_precision(
            y_bin, p_te, float(cfg.get("precision_target", 0.90) or 0.90)
        ),
        ece=M.expected_calibration_error(y_bin, p_te),
        n_test=int(len(y_bin)),
    )


def finish_run(cfg: dict, outdir: str, data, probs: np.ndarray, best_val: float,
               extra: Optional[dict] = None, write: bool = True) -> dict:
    """Artifact + metrics emission: the run-directory contract. `probs` are
    calibrated P(illicit) for all nodes. `write=False` (every rank but the
    primary) computes the metrics without touching the disk."""
    y_np = data.y
    val_mask, test_mask = data.val_mask, data.test_mask
    timestep_np = data.timestep

    y_val, p_val = y_np[val_mask], probs[val_mask]
    y_te, p_te = y_np[test_mask], probs[test_mask]

    # node indices in ON-DISK numbering even though training ran on the
    # BFS-renumbered graph
    orig = (
        data.orig_index
        if data.orig_index is not None
        else np.arange(len(y_np), dtype=np.int64)
    )
    if write:
        np.save(os.path.join(outdir, "scores_val.npy"), p_val)
        np.save(os.path.join(outdir, "y_val.npy"), y_val)
        np.save(os.path.join(outdir, "node_idx_val.npy"), orig[val_mask])
        np.save(os.path.join(outdir, "timestep_val.npy"), timestep_np[val_mask])
        np.save(os.path.join(outdir, "scores_test.npy"), p_te)
        np.save(os.path.join(outdir, "y_test.npy"), y_te)
        np.save(os.path.join(outdir, "node_idx_test.npy"), orig[test_mask])
        np.save(os.path.join(outdir, "timestep_test.npy"), timestep_np[test_mask])

    if cfg.get("use_val_for_thresholds", True):
        pt = float(cfg.get("precision_target", 0.0) or 0.0)
        if pt > 0:
            thr = M.pick_threshold_for_precision((y_val == 1).astype(int), p_val, pt)
        else:
            thr, _ = M.pick_threshold_max_f1((y_val == 1).astype(int), p_val)
    else:
        thr, _ = M.pick_threshold_max_f1((y_te == 1).astype(int), p_te)

    y_bin = (y_te == 1).astype(int)
    metrics = test_metrics_at_threshold(cfg, y_bin, p_te, thr)
    metrics["best_val_pr_auc"] = best_val

    test_ts = timestep_np[test_mask]
    if test_ts.size > 0:
        _, pr_by_t = M.per_timestep_pr_auc(y_bin, p_te, test_ts)
        metrics["test_pr_auc_by_time"] = pr_by_t
        if pr_by_t:
            metrics["pr_auc_last1"] = float(pr_by_t[-1])
            metrics.update(M.tail_means(pr_by_t, ks=(3, 5)))
    if extra:
        metrics.update(extra)

    if write:
        save_json(os.path.join(outdir, "metrics.json"), metrics)
    return metrics


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args()
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    main(cfg)
