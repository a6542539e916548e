"""Common utilities: seeding, filesystem helpers, device selection.

Counterpart of elliptic_gnn_tpu/utils/common.py. Seeding covers torch as
well; device randomness (dropout, init) uses explicit torch.Generators.
"""
from __future__ import annotations

import json
import os
import random
from typing import Any

import numpy as np
import torch


def set_seed(seed: int = 42) -> None:
    """Seed host-side RNGs and torch's default generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def _to_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def save_json(path: str, obj: Any) -> None:
    ensure_dir(os.path.dirname(path) or ".")
    with open(path, "w") as f:
        json.dump(_to_jsonable(obj), f, indent=2)


def dropout(h: torch.Tensor, rate: float, training: bool,
            generator=None) -> torch.Tensor:
    """Inverted dropout with the mask drawn from `generator` (on h's
    device); the identity outside training or at rate 0."""
    if not training or rate <= 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


def resolve_device(name) -> torch.device:
    """`auto` and `cuda` mean the GPU and raise when there is none; the CPU
    is used only when asked for by name."""
    name = "auto" if name is None else str(name)
    if name in ("auto", "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device: {name} needs a CUDA GPU and none is available; "
                "set `device: cpu` to run on the CPU"
            )
        return torch.device("cuda")
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}; expected auto, cuda or cpu")


def log_device_info(device: torch.device) -> None:
    if device.type == "cuda":
        idx = device.index if device.index is not None else torch.cuda.current_device()
        print(f"[DEV] backend=cuda n_devices={torch.cuda.device_count()} "
              f"device={torch.cuda.get_device_name(idx)}")
    else:
        print("[DEV] backend=cpu")
