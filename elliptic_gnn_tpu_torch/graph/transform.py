"""Graph-level preprocessing transforms (host side, one-time); copy of
elliptic_gnn_tpu/graph/transform.py.

Equivalents of the inline preprocessing in the reference trainer:
  - symmetrize_edges: concat [edge_index, flipped] (train_gnn.py:320-326)
  - append_scalar_time: x ++ t / t.max() column (train_gnn.py:315-317)
  - add_self_loops: PyG-convention self loops appended after real edges
    (implicit in GCNConv/GATConv defaults)
and the edge perturbations of the analysis tools (drop_edges,
remove_hub_edges).
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


def drop_edges(edge_index: np.ndarray, drop_frac: float, seed: int = 0) -> np.ndarray:
    """Uniform random edge drop (robustness analysis)."""
    e = edge_index.shape[1]
    n_keep = e - int(round(drop_frac * e))
    rng = np.random.default_rng(seed)
    keep = rng.permutation(e)[:n_keep]
    return edge_index[:, np.sort(keep)]


def remove_hub_edges(edge_index: np.ndarray, num_nodes: int, frac: float):
    """Drop all edges touching the top-`frac` highest-degree nodes.

    Degree = in + out over the *used* edge set, like the inline hub ablation.
    Returns (edge_index_ablated, num_hubs).
    """
    num_hubs = int(frac * float(num_nodes))
    deg = np.bincount(edge_index[0], minlength=num_nodes) + np.bincount(
        edge_index[1], minlength=num_nodes
    )
    hubs = np.zeros(num_nodes, dtype=bool)
    if num_hubs > 0:
        top = np.argpartition(-deg, num_hubs - 1)[:num_hubs]
        hubs[top] = True
    keep = ~(hubs[edge_index[0]] | hubs[edge_index[1]])
    return edge_index[:, keep], num_hubs
