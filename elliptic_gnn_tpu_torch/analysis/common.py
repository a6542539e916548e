"""Run-dir loading and the model-reload pattern (port of
elliptic_gnn_tpu/analysis/common.py, the parts train/predict.py needs).

A post-hoc tool reads `config_used.yaml` from the run dir, reproduces the
data preparation (window, scalar time, symmetrize), rebuilds the
aggregation tables and the model as the trainer built them, loads
`best.ckpt`, and evaluates.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
import yaml


def load_run_config(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "config_used.yaml")) as f:
        return yaml.safe_load(f)


def load_run_metrics(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "metrics.json")) as f:
        return json.load(f)


def rebuild_model_and_data(run_dir: str, processed_dir: Optional[str] = None,
                           device: Optional[str] = None) -> Tuple:
    """Reload pattern: config -> prepared data -> tables + model ->
    best.ckpt. Returns (cfg, data, gops, model) with tables and model on
    the config's device (`device` overrides it); data is BFS-renumbered as
    in training, data.orig_index translates back."""
    from ..models import build_model
    from ..train import checkpoint
    from ..train.train_gnn import build_graph_ops, prepare_data
    from ..utils.common import resolve_device

    cfg = load_run_config(run_dir)
    if processed_dir:
        cfg = dict(cfg, processed_dir=processed_dir)
    if device:
        cfg = dict(cfg, device=device)
    dev = resolve_device(cfg.get("device", "auto"))
    data, gops = build_graph_ops(cfg, prepare_data(cfg), dev, training=False)
    model = build_model(cfg["arch"], data.num_features, cfg)
    checkpoint.load_best(run_dir, model)
    return cfg, data, gops, model.to(dev).eval()


def model_probs(data, gops, model, temperature: Optional[float] = None) -> np.ndarray:
    """Full-graph calibrated P(illicit), as the trainer's final scoring
    pass computes it."""
    from ..train.calibrate import calibrated_probs

    device = next(model.parameters()).device
    x = torch.as_tensor(data.x, dtype=torch.float32, device=device)
    t = (torch.as_tensor(data.timestep.astype(np.int32), device=device)
         if model.uses_time_embed else None)
    with torch.no_grad():
        lg = model(x, gops, t).cpu().numpy()
    if temperature is None or temperature <= 0:
        temperature = 1.0
    return calibrated_probs(lg, temperature)
