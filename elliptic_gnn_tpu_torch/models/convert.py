"""Load parameters of the JAX SAGE-ResBN model into the port's module.

The JAX pytree, already converted to numpy arrays:

    params = {"layers": [{"w_l", "b_l", "w_r"}], "bns": [{"scale", "bias"}],
              "res_projs": [None | {"w"}], "time_emb" (learned embedding)}
    state  = {"bns": [{"mean", "var", "count"}]}

JAX stores dense weights as [d_in, d_out]; nn.Linear holds [d_out, d_in].
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .modules import SageResBN


def _copy(dst: torch.Tensor, src, transpose: bool = False) -> None:
    v = np.asarray(src, np.float32)
    if transpose:
        v = v.T
    if tuple(v.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: JAX {v.shape} vs port {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(v, copy=True)))


def params_from_jax(params_np: dict, state_np: dict, model: SageResBN) -> SageResBN:
    """Copy the JAX parameters and BN state into `model` in place; returns it."""
    with torch.no_grad():
        if len(params_np["layers"]) != len(model.layers):
            raise ValueError("layer count differs between JAX params and model")
        for layer, p in zip(model.layers, params_np["layers"]):
            _copy(layer.lin_l.weight, p["w_l"], transpose=True)
            _copy(layer.lin_l.bias, p["b_l"])
            _copy(layer.lin_r.weight, p["w_r"], transpose=True)
        if model.bns is not None:
            for bn, p, s in zip(model.bns, params_np["bns"], state_np["bns"]):
                _copy(bn.scale, p["scale"])
                _copy(bn.bias, p["bias"])
                _copy(bn.mean, s["mean"])
                _copy(bn.var, s["var"])
                _copy(bn.count, s["count"])
        if model.res_projs is not None:
            for proj, p in zip(model.res_projs, params_np["res_projs"]):
                if (p is None) != isinstance(proj, nn.Identity):
                    raise ValueError("residual projection layout differs")
                if p is not None:
                    _copy(proj.weight, p["w"], transpose=True)
        if model.time_emb is not None:
            _copy(model.time_emb, params_np["time_emb"])
    return model
