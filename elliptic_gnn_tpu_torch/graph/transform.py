"""Graph-level preprocessing transforms (host side, one-time); copy of
elliptic_gnn_tpu/graph/transform.py.

Equivalents of the inline preprocessing in the reference trainer:
  - symmetrize_edges: concat [edge_index, flipped] (train_gnn.py:320-326)
  - append_scalar_time: x ++ t / t.max() column (train_gnn.py:315-317)
  - add_self_loops: PyG-convention self loops appended after real edges
    (implicit in GCNConv/GATConv defaults)
"""
from __future__ import annotations

import numpy as np

from .data import GraphData


def symmetrize_edges(data: GraphData) -> GraphData:
    ei = data.edge_index
    flipped = ei[::-1]
    return data.replace(edge_index=np.concatenate([ei, flipped], axis=1))


def append_scalar_time(data: GraphData) -> GraphData:
    tnorm = (data.timestep.astype(np.float32) / float(data.timestep.max()))[:, None]
    return data.replace(x=np.concatenate([data.x, tnorm], axis=1))


def add_self_loops(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    loops = np.arange(num_nodes, dtype=edge_index.dtype)
    return np.concatenate([edge_index, np.stack([loops, loops])], axis=1)
