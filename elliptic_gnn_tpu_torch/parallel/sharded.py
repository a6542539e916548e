"""Row sharding of the node arrays and the aggregation tables (port of
elliptic_gnn_tpu/parallel/sharded.py).

Node rows are padded and split into one contiguous block per rank; padded
rows are unlabeled (train mask 0), edge-free, and excluded from BatchNorm
statistics through `row_mask`, so a sharded run computes what one device
computes. BSDA graphs pad to their chunk grid (tables padded beforehand
with kernels/bsda.py::pad_bsda_chunks, so that every rank has the same
number of rows: an all-gather takes equal blocks), ELL graphs to a
multiple of the rank count.

The halo path partitions its own tables (shardmap_step.partition_bsda) and
takes the node arrays alone (`shard_tables=False`). The GSPMD path takes
the tables too: each function computes the JAX package's arrays, then this
rank's share of them (parallel/gspmd_step.py).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..kernels.bsda import BsdaGraph
from ..kernels.ell import EllGraph
from ..utils.common import upload
from .gspmd_step import RowShardedBsda, row_sharded_bsda, row_sharded_ell
from .mesh import Mesh


def pad_to_multiple(arr: np.ndarray, m: int, axis: int = 0, fill=0) -> np.ndarray:
    n = arr.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def shard_ell_graph(g: EllGraph, mesh: Mesh) -> EllGraph:
    """The JAX package's sharded ELL tables, on the CPU: each bucket's rows
    padded to a multiple of the mesh size (padded rows point at node 0 with
    zero weight and are never referenced by inv_perm), the zero-degree
    block grown likewise, and inv_perm remapped to the padded offsets and
    padded to the mesh. gspmd_step.row_sharded_ell cuts a rank's rows out
    of it."""
    n_dev = mesh.size

    def rows_padded(t):
        return torch.from_numpy(pad_to_multiple(_np(t), n_dev, axis=0))

    nbrs = tuple(rows_padded(t) for t in g.nbrs)
    old_sizes = [int(t.shape[0]) for t in g.nbrs]
    new_sizes = [int(t.shape[0]) for t in nbrs]
    zero_old = g.n_zero_deg
    zero_new = ((-zero_old) % n_dev) + zero_old if zero_old else 0

    old_offsets = np.cumsum([0] + old_sizes)
    new_offsets = np.cumsum([0] + new_sizes)
    inv = (np.arange(g.num_nodes, dtype=np.int64) if g.inv_perm is None
           else _np(g.inv_perm).astype(np.int64))
    remapped = np.empty_like(inv)
    for b in range(len(old_sizes)):
        sel = (inv >= old_offsets[b]) & (inv < old_offsets[b + 1])
        remapped[sel] = inv[sel] - old_offsets[b] + new_offsets[b]
    sel = inv >= old_offsets[-1]  # zero-degree block
    remapped[sel] = inv[sel] - old_offsets[-1] + new_offsets[-1]

    return EllGraph(
        nbrs=nbrs,
        weights=tuple(rows_padded(t) for t in g.weights),
        rows=tuple(rows_padded(t) for t in g.rows),
        inv_perm=torch.from_numpy(pad_to_multiple(remapped, n_dev)),
        row_scale=tuple(rows_padded(t) for t in g.row_scale),
        num_nodes=g.num_nodes,
        widths=g.widths,
        n_zero_deg=zero_new,
    )


def _extend_for_padding(g: EllGraph, n_padded: int) -> EllGraph:
    """Grow the node count to n_padded: padded nodes are zero-degree,
    their positions appended at the end of the zero block."""
    extra = n_padded - g.num_nodes
    if extra <= 0:
        return g
    total_rows = sum(int(t.shape[0]) for t in g.nbrs)
    inv = (np.arange(g.num_nodes, dtype=np.int64) if g.inv_perm is None
           else _np(g.inv_perm).astype(np.int64))
    new_positions = np.arange(total_rows + g.n_zero_deg,
                              total_rows + g.n_zero_deg + extra, dtype=np.int64)
    return dataclasses.replace(
        g, inv_perm=torch.from_numpy(np.concatenate([inv, new_positions])),
        num_nodes=n_padded, n_zero_deg=g.n_zero_deg + extra)


def shard_bsda_graph(g: BsdaGraph, mesh: Mesh) -> RowShardedBsda:
    """This rank's share of the BSDA tables (the JAX package shards them
    over destination chunks and keeps the values): its destination chunks,
    forward and transpose, in the rectangular form the GSPMD aggregation
    runs (gspmd_step.row_sharded_bsda), on the rank's device. The chunk
    grid must tile the mesh (kernels/bsda.py::pad_bsda_chunks)."""
    return row_sharded_bsda(g, mesh.size, mesh.rank, mesh.group).to(mesh.device)


def pad_graph_inputs(data, gops, n_dev: int) -> Tuple:
    """The JAX package's padded node arrays, on the host: (x, y, timestep,
    train_mask_f, row_mask, n_pad); BSDA rows padded to the chunk grid of
    `gops`, ELL rows to a multiple of n_dev (timestep filled with 1)."""
    n0 = data.num_nodes
    if isinstance(gops, BsdaGraph):
        n_target = gops.num_chunks * gops.chunk

        def pad(a, fill=0):
            widths = [(0, n_target - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, widths, constant_values=fill)
    else:
        def pad(a, fill=0):
            return pad_to_multiple(a, n_dev, fill=fill)

    x = pad(data.x)
    return (x, pad(np.maximum(data.y, 0).astype(np.int64)),
            pad(data.timestep.astype(np.int32), fill=1),
            pad(data.train_mask.astype(np.float32)),
            (np.arange(x.shape[0]) < n0).astype(np.float32), x.shape[0] - n0)


def shard_graph_inputs(mesh: Mesh, data, gops, shard_tables: bool = False) -> Tuple:
    """This rank's rows of the node arrays on its device: (x, y, timestep,
    train_mask_f, row_mask, n_padded), the rows of pad_graph_inputs cut to
    rank r's block. A BsdaGraph's chunk grid must tile the mesh (the tables
    padded with pad_bsda_chunks: num_chunks * chunk rows, the least
    multiple of size * chunk that holds every node).

    `shard_tables` (the GSPMD path): (x, y, timestep, train_mask_f,
    row_mask, gops_rank, n_padded), gops_rank this rank's share of the
    tables (shard_bsda_graph; an EllGraph extended to the padded rows and
    sharded as the JAX package shards it, then cut to the rank's rows)."""
    n0 = data.num_nodes
    if isinstance(gops, BsdaGraph):
        m = mesh.size * gops.chunk
        if gops.num_chunks * gops.chunk != -(-n0 // m) * m:
            raise ValueError(f"{gops.num_chunks} chunks of {gops.chunk} rows are not the grid "
                             f"of {n0} nodes over {mesh.size} ranks; pad the tables with "
                             "kernels/bsda.py::pad_bsda_chunks")
    x, y, t, tm, rm, n_pad = pad_graph_inputs(data, gops, mesh.size)
    n_loc = x.shape[0] // mesh.size
    rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)

    def local(a, dtype=None):
        return upload(np.ascontiguousarray(a[rows]), mesh.device, dtype)

    arrays = (local(x, torch.float32), local(y), local(t), local(tm), local(rm))
    if not shard_tables:
        return arrays + (n_pad,)
    if isinstance(gops, BsdaGraph):
        gops_rank = shard_bsda_graph(gops, mesh)
    else:
        g_sh = shard_ell_graph(_extend_for_padding(gops, x.shape[0]), mesh)
        gops_rank = row_sharded_ell(g_sh, mesh.size, mesh.rank, mesh.group).to(mesh.device)
    return arrays + (gops_rank, n_pad)
