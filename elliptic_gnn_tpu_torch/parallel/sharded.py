"""Row sharding of the node arrays (port of the part of
elliptic_gnn_tpu/parallel/sharded.py that the explicit halo path uses).

Node rows are padded to the BSDA chunk grid and split into one contiguous
block per rank; padded rows are unlabeled (train mask 0), edge-free, and
excluded from BatchNorm statistics through `row_mask`, so a sharded run
computes what one device computes. The halo path partitions its own tables
(shardmap_step.partition_bsda); the GSPMD row sharding of the tables
(ELL graphs, `shard_ell_graph`/`shard_bsda_graph`) is not ported yet
(ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels.bsda import BsdaGraph
from ..utils.common import upload
from .mesh import Mesh


def pad_to_multiple(arr: np.ndarray, m: int, axis: int = 0, fill=0) -> np.ndarray:
    n = arr.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def shard_graph_inputs(mesh: Mesh, data, gops: BsdaGraph) -> Tuple:
    """This rank's rows of the node arrays on its device: (x, y, timestep,
    train_mask_f, row_mask, n_padded). The arrays are padded to the chunk
    grid of `gops`, the tables that pad_bsda_chunks tiled over the mesh
    (num_chunks * chunk rows, the least multiple of size * chunk that holds
    every node), and sliced to rank r's block of rows."""
    n0 = data.num_nodes
    m = mesh.size * gops.chunk
    n_target = gops.num_chunks * gops.chunk
    if n_target != -(-n0 // m) * m:
        raise ValueError(f"{gops.num_chunks} chunks of {gops.chunk} rows are not the grid "
                         f"of {n0} nodes over {mesh.size} ranks; pad the tables with "
                         "kernels/bsda.py::pad_bsda_chunks")
    n_loc = n_target // mesh.size
    rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)

    def local(a, dtype=None, fill=0):
        return upload(np.ascontiguousarray(pad_to_multiple(a, m, fill=fill)[rows]),
                      mesh.device, dtype)

    return (
        local(data.x, torch.float32),
        local(np.maximum(data.y, 0).astype(np.int64)),
        local(data.timestep.astype(np.int32), fill=1),
        local(data.train_mask.astype(np.float32)),
        local(np.ones(n0, np.float32)),
        n_target - n0,
    )
