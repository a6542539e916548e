"""Run-dir loading and the model-reload pattern (port of
elliptic_gnn_tpu/analysis/common.py).

A post-hoc tool reads `config_used.yaml` from the run dir, reproduces the
data preparation (window, scalar time, symmetrize), optionally perturbs the
edges or features (hub ablation, robustness), rebuilds the aggregation
tables and the model as the trainer built them, loads `best.ckpt`, and
evaluates.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import yaml

from ..utils.common import upload


def pyplot(png: str, tag: str):
    """matplotlib's pyplot on the Agg backend for drawing `png`, or None
    where matplotlib does not import: the tool has then written its data
    artifacts (CSV, JSON) already, says that the figure was not drawn, and
    goes on."""
    try:
        import matplotlib
    except ImportError:
        print(f"[{tag}] matplotlib is not importable: {os.path.basename(png)} not drawn")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_run_config(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "config_used.yaml")) as f:
        return yaml.safe_load(f)


def load_run_metrics(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "metrics.json")) as f:
        return json.load(f)


def load_run_arrays(run_dir: str, split: str = "test") -> Dict[str, np.ndarray]:
    """Load the npy artifact set for a split: scores, y, node_idx, timestep."""
    return {name: np.load(os.path.join(run_dir, f"{name}_{split}.npy"))
            for name in ("scores", "y", "node_idx", "timestep")}


def load_run_data(run_dir: str, processed_dir: Optional[str] = None) -> Tuple:
    """(cfg, data): the run's config and its prepared graph in on-disk node
    numbering, as the JAX package's tools see it."""
    from ..train.train_gnn import prepare_data

    cfg = load_run_config(run_dir)
    if processed_dir:
        cfg = dict(cfg, processed_dir=processed_dir)
    return cfg, prepare_data(cfg)


def load_model(cfg: dict, num_features: int, run_dir: str,
               device: torch.device) -> torch.nn.Module:
    """The run's model with its best.ckpt, on `device`, in eval mode."""
    from ..models import build_model
    from ..train import checkpoint

    model = build_model(cfg["arch"], num_features, cfg)
    checkpoint.load_best(run_dir, model)
    return model.to(device).eval()


def rebuild_on(cfg: dict, data, run_dir: str, device: Optional[str] = None) -> Tuple:
    """(data, gops, model) for prepared `data` (perturbed or not): data
    BFS-renumbered as in training (data.orig_index translates back), its
    tables and the model with the run's best.ckpt on the config's device
    (`device` overrides it). A run that trained on the halo path
    (`aggregation: shard_map` or a mesh) is scored with the single-device
    BSDA encoding, as its trainer scored it."""
    from ..train.train_gnn import build_graph_ops
    from ..utils.common import resolve_device

    dev = resolve_device(device or cfg.get("device", "auto"))
    data, gops = build_graph_ops(cfg, data, dev, training=False)
    return data, gops, load_model(cfg, data.num_features, run_dir, dev)


def rebuild_model_and_data(run_dir: str, edge_index_override: Optional[np.ndarray] = None,
                           processed_dir: Optional[str] = None,
                           device: Optional[str] = None) -> Tuple:
    """Reload pattern: config -> prepared data -> tables + model ->
    best.ckpt. Returns (cfg, data, gops, model) with tables and model on
    the config's device (`device` overrides it); data is BFS-renumbered as
    in training, data.orig_index translates back. `edge_index_override`,
    in on-disk numbering, replaces the prepared edges before the tables are
    built (hub ablation, robustness)."""
    cfg, data = load_run_data(run_dir, processed_dir)
    if edge_index_override is not None:
        data = data.replace(edge_index=np.asarray(edge_index_override))
    return (cfg,) + rebuild_on(cfg, data, run_dir, device)


def model_logits(data, gops, model) -> np.ndarray:
    """Full-graph eval logits [N, 2] on the host."""
    device = next(model.parameters()).device
    x = upload(data.x, device, torch.float32)
    t = (upload(data.timestep.astype(np.int32), device)
         if model.uses_time_embed else None)
    with torch.no_grad():
        return model(x, gops, t).cpu().numpy()


def model_probs(data, gops, model, temperature: Optional[float] = None) -> np.ndarray:
    """Full-graph calibrated P(illicit), as the trainer's final scoring
    pass computes it."""
    from ..train.calibrate import calibrated_probs

    if temperature is None or temperature <= 0:
        temperature = 1.0
    return calibrated_probs(model_logits(data, gops, model), temperature)
