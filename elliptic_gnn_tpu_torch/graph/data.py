"""Graph container + processed-artifact IO.

Copy of elliptic_gnn_tpu/graph/data.py: a plain dataclass of numpy
arrays, persisted as a compressed .npz plus a meta.json (the same on-disk
format, so either package reads the other's processed graphs).
Keeping the on-disk format as npz (instead of a Python pickle) makes the
processed graph language-neutral and safely memory-mappable.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from ..utils.common import ensure_dir, load_json, save_json

GRAPH_FILE = "graph.npz"
META_FILE = "meta.json"


@dataclasses.dataclass
class GraphData:
    """A single static graph with node features, labels and timesteps.

    x:          [N, F] float32 node features
    y:          [N] int32 labels in {-1 (unknown), 0 (licit), 1 (illicit)}
    timestep:   [N] int32 in [1..T]
    edge_index: [2, E] int32, directed src -> dst
    train/val/test_mask: [N] bool (optional until make_temporal_masks)
    """

    x: np.ndarray
    y: np.ndarray
    timestep: np.ndarray
    edge_index: np.ndarray
    train_mask: Optional[np.ndarray] = None
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None
    # After an in-memory renumbering (kernels.bsda.bfs_order),
    # orig_index[i] is row i's node id in the on-disk graph; artifacts
    # (node_idx_*.npy) always report original ids. None = identity.
    orig_index: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])

    def replace(self, **kw) -> "GraphData":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        n = self.num_nodes
        assert self.y.shape == (n,)
        assert self.timestep.shape == (n,)
        assert self.edge_index.ndim == 2 and self.edge_index.shape[0] == 2
        if self.num_edges:
            assert self.edge_index.min() >= 0 and self.edge_index.max() < n
        for m in (self.train_mask, self.val_mask, self.test_mask):
            if m is not None:
                assert m.shape == (n,) and m.dtype == np.bool_
        if self.orig_index is not None:
            assert self.orig_index.shape == (n,)

    def renumber(self, rank: np.ndarray) -> "GraphData":
        """Relabel nodes: new id = rank[old id]. Per-node arrays are
        permuted, edge endpoints remapped, and orig_index tracks the way
        back to on-disk ids."""
        perm = np.argsort(rank)  # perm[new_id] = old_id
        prev_orig = self.orig_index if self.orig_index is not None else np.arange(
            self.num_nodes, dtype=np.int64
        )

        def take(a):
            return None if a is None else a[perm]

        return self.replace(
            x=self.x[perm],
            y=self.y[perm],
            timestep=self.timestep[perm],
            edge_index=rank[self.edge_index].astype(self.edge_index.dtype),
            train_mask=take(self.train_mask),
            val_mask=take(self.val_mask),
            test_mask=take(self.test_mask),
            orig_index=prev_orig[perm],
        )

    def meta(self) -> Dict:
        y = self.y
        return {
            "num_nodes": self.num_nodes,
            "num_edges": self.num_edges,
            "num_features": self.num_features,
            "label_counts": {
                "-1": int((y == -1).sum()),
                "0": int((y == 0).sum()),
                "1": int((y == 1).sum()),
            },
        }


def save_processed(data: GraphData, processed_dir: str, extra_meta: Optional[Dict] = None) -> None:
    ensure_dir(processed_dir)
    arrays = {
        "x": data.x.astype(np.float32),
        "y": data.y.astype(np.int32),
        "timestep": data.timestep.astype(np.int32),
        "edge_index": data.edge_index.astype(np.int32),
    }
    for name in ("train_mask", "val_mask", "test_mask"):
        v = getattr(data, name)
        if v is not None:
            arrays[name] = v.astype(np.bool_)
    np.savez_compressed(os.path.join(processed_dir, GRAPH_FILE), **arrays)
    meta = data.meta()
    if extra_meta:
        meta.update(extra_meta)
    save_json(os.path.join(processed_dir, META_FILE), meta)


def load_processed(processed_dir: str) -> GraphData:
    path = os.path.join(processed_dir, GRAPH_FILE)
    if not os.path.exists(path):
        raise RuntimeError(
            f"{path} not found. Build the graph first: "
            "python -m elliptic_gnn_tpu_torch.graph.build_graph --config configs/split.yaml"
        )
    with np.load(path) as z:
        kw = {k: z[k] for k in z.files}
    return GraphData(**kw)


def load_meta(processed_dir: str) -> Dict:
    return load_json(os.path.join(processed_dir, META_FILE))
