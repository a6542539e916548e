"""Checkpointing (port of elliptic_gnn_tpu/train/checkpoint.py, best
snapshot only).

`best.ckpt` is the JAX package's artifact: a flat npz of the best model's
parameters and BatchNorm state, {"params/...": ..., "state/...": ...},
each key the '/'-joined path of an array in the JAX model's pytrees
(models/convert.py::params_to_jax), e.g. params/layers/0/w_l,
params/bns/1/scale, params/res_projs/1/w, state/bns/0/mean. The JAX
package's tools read a port run's best.ckpt, and the port's
train/predict.py and analysis/common.py read a JAX run's. Mid-training
resume (`resume.ckpt`) is not ported; the trainer raises on `resume`.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
from torch import nn

from ..models.convert import params_from_jax, params_to_jax


def _key(prefix: str, k) -> str:
    return f"{prefix}/{k}" if prefix else str(k)


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'/'-joined path: array} of a pytree of dicts, lists and arrays, as
    the JAX package's _flatten keys it: dict keys and list indices. None
    holds no array, as in JAX's tree flatten."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(flatten(v, _key(prefix, k)))
    return flat


def _fill(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    """`template`'s structure with every array taken from `flat`; a missing
    or mis-shaped entry raises."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _fill(v, flat, _key(prefix, k)) for k, v in template.items()}
    if isinstance(template, list):
        return [_fill(v, flat, _key(prefix, i)) for i, v in enumerate(template)]
    if prefix not in flat:
        raise KeyError(f"best.ckpt has no entry {prefix}")
    arr = flat[prefix]
    if arr.shape != np.shape(template):
        raise ValueError(f"shape mismatch for {prefix}: ckpt {arr.shape} vs "
                         f"model {np.shape(template)}")
    return arr


def save_best(outdir: str, model: nn.Module) -> None:
    params, state = params_to_jax(model)
    with open(os.path.join(outdir, "best.ckpt"), "wb") as fh:
        np.savez(fh, **flatten({"params": params, "state": state}))


def load_best(outdir: str, model: nn.Module) -> nn.Module:
    """Load best.ckpt into `model` (built from the run's config) in place.
    A file that is not an npz in the JAX layout, or that lacks an entry
    the model needs or holds it in another shape, raises."""
    path = os.path.join(outdir, "best.ckpt")
    try:
        z = np.load(path, allow_pickle=False)
    except ValueError as exc:
        raise ValueError(f"{path} is not an npz checkpoint: {exc}") from exc
    if not isinstance(z, np.lib.npyio.NpzFile):
        raise ValueError(f"{path} is not an npz checkpoint")
    with z:
        names = [k for k in z.files if k.startswith(("params/", "state/"))]
        if not names:
            raise ValueError(
                f"{path} holds no params/ or state/ entries: not a checkpoint in "
                f"the JAX npz layout (a torch.save file of an older port run?)")
        flat = {k: z[k] for k in names}
    params, state = params_to_jax(model)
    tree = _fill({"params": params, "state": state}, flat)
    return params_from_jax(tree["params"], tree["state"], model)
