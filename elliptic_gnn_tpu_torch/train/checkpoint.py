"""Checkpointing (port of elliptic_gnn_tpu/train/checkpoint.py, best
snapshot only).

`best.ckpt` holds the state dict of the best model (parameters and
BatchNorm buffers) as torch.save writes it: the port's own format, the
counterpart of the JAX package's flat npz and not readable by it. It is
loaded by train/predict.py and analysis/common.py. Mid-training resume
(`resume.ckpt`) is not ported; the trainer raises on `resume`.
"""
from __future__ import annotations

import os

import torch
from torch import nn


def save_best(outdir: str, model: nn.Module) -> None:
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(outdir, "best.ckpt"))


def load_best(outdir: str, model: nn.Module) -> nn.Module:
    """Load best.ckpt into `model` (built from the run's config) in place.
    Missing, unexpected or mis-shaped entries raise."""
    state = torch.load(os.path.join(outdir, "best.ckpt"), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state, strict=True)
    return model
