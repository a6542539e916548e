"""Parameters of a JAX model in and out of the port's module.

`params_from_jax` loads them into a module, `params_to_jax` gives a
module's back as the JAX pytrees. The JAX pytrees, as numpy arrays.
SAGE-ResBN:

    params = {"layers": [{"w_l", "b_l", "w_r"}], "bns": [{"scale", "bias"}],
              "res_projs": [None | {"w"}], "time_emb" (learned embedding)}
    state  = {"bns": [{"mean", "var", "count"}]}

JAX stores dense weights as [d_in, d_out]; nn.Linear holds [d_out, d_in].
GAT: params = {"layers": [{"w" [F, H, Ch], "a_src", "a_dst" [H, Ch], "b"}]},
no state; the port keeps the same shapes. GCN: {"layers": [{"w", "b"}]};
SAGE: {"layers": [{"w_l", "b_l", "w_r"}]}; no state either. EvolveGCN-O,
which the JAX package lacks, in the same flat layout: params = {"grcu":
[{"q0", "w_u", "u_u", "b_u", "w_r", "u_r", "b_r", "w_h", "u_h", "b_h"}],
"cls": [{"w", "b"}]} (each GRCU tensor as the port holds it), no state.

Both take an optional map from each of the module's tensors (parameter or
BN buffer) to the tensor read or written in its place, so that the same
layout carries a saved best model or Adam's moments (train/checkpoint.py).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels.egcn_evolve import PARAMS as EGCN_PARAMS
from .egcn import EvolveGCNO
from .modules import GAT, GCN, SAGE, SageResBN


def _copy_into(dst: torch.Tensor, src, transpose: bool = False) -> None:
    v = np.asarray(src, np.float32)
    if transpose:
        v = v.T
    if tuple(v.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: JAX {v.shape} vs port {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(v, copy=True)))


def params_from_jax(params_np: dict, state_np, model: nn.Module,
                    put=None) -> nn.Module:
    """Copy the JAX parameters and BN state into `model` in place; returns
    it. `put(t)` names the tensor written in place of the module's tensor t
    (default t itself); `state_np` None leaves the BN state alone."""
    if put is not None:
        def _copy(dst, src, transpose=False):
            _copy_into(put(dst), src, transpose)
    else:
        _copy = _copy_into
    with torch.no_grad():
        if isinstance(model, EvolveGCNO):
            if len(params_np["grcu"]) != len(model.grcu):
                raise ValueError("GRCU layer count differs between checkpoint and model")
            for layer, p in zip(model.grcu, params_np["grcu"]):
                for name in EGCN_PARAMS:
                    _copy(getattr(layer, name), p[name])
            for lin, p in zip(model.cls, params_np["cls"]):
                _copy(lin.weight, p["w"], transpose=True)
                _copy(lin.bias, p["b"])
            return model
        if len(params_np["layers"]) != len(model.layers):
            raise ValueError("layer count differs between JAX params and model")
        if isinstance(model, GAT):
            for layer, p in zip(model.layers, params_np["layers"]):
                for name in ("w", "a_src", "a_dst", "b"):
                    _copy(getattr(layer, name), p[name])
            return model
        if isinstance(model, GCN):
            for layer, p in zip(model.layers, params_np["layers"]):
                _copy(layer.lin.weight, p["w"], transpose=True)
                _copy(layer.bias, p["b"])
            return model
        if not isinstance(model, (SAGE, SageResBN)):
            raise TypeError(f"no JAX counterpart known for {type(model).__name__}")
        for layer, p in zip(model.layers, params_np["layers"]):
            _copy(layer.lin_l.weight, p["w_l"], transpose=True)
            _copy(layer.lin_l.bias, p["b_l"])
            _copy(layer.lin_r.weight, p["w_r"], transpose=True)
        if isinstance(model, SAGE):
            return model
        if model.bns is not None:
            for bn, p in zip(model.bns, params_np["bns"]):
                _copy(bn.scale, p["scale"])
                _copy(bn.bias, p["bias"])
            for bn, s in zip(model.bns, [] if state_np is None else state_np["bns"]):
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


def _np_of(t: torch.Tensor, transpose: bool = False) -> np.ndarray:
    v = t.detach().cpu().float().numpy()
    return np.array(v.T if transpose else v, order="C")  # 0-d stays 0-d


def params_to_jax(model: nn.Module, take=None):
    """The inverse of params_from_jax: (params_np, state_np), the JAX
    model's pytrees as numpy arrays. Dense weights go back to [d_in,
    d_out]; an identity residual projection is None, as in the JAX
    params; the BN count is a 0-d array. `take(t)` names the tensor read in
    place of the module's tensor t (default t itself)."""
    if take is not None:
        def _np(t, transpose=False):
            return _np_of(take(t), transpose)
    else:
        _np = _np_of
    if isinstance(model, EvolveGCNO):
        return {"grcu": [{name: _np(getattr(layer, name)) for name in EGCN_PARAMS}
                         for layer in model.grcu],
                "cls": [{"w": _np(lin.weight, True), "b": _np(lin.bias)}
                        for lin in model.cls]}, {}
    if isinstance(model, GAT):
        return {"layers": [{name: _np(getattr(layer, name))
                            for name in ("w", "a_src", "a_dst", "b")}
                           for layer in model.layers]}, {}
    if isinstance(model, GCN):
        return {"layers": [{"w": _np(layer.lin.weight, True), "b": _np(layer.bias)}
                           for layer in model.layers]}, {}
    if not isinstance(model, (SAGE, SageResBN)):
        raise TypeError(f"no JAX counterpart known for {type(model).__name__}")
    params = {"layers": [{"w_l": _np(layer.lin_l.weight, True),
                          "b_l": _np(layer.lin_l.bias),
                          "w_r": _np(layer.lin_r.weight, True)}
                         for layer in model.layers]}
    state: dict = {}
    if isinstance(model, SAGE):
        return params, state
    if model.bns is not None:
        params["bns"] = [{"scale": _np(bn.scale), "bias": _np(bn.bias)}
                         for bn in model.bns]
        state["bns"] = [{"mean": _np(bn.mean), "var": _np(bn.var),
                         "count": _np(bn.count)} for bn in model.bns]
    if model.res_projs is not None:
        params["res_projs"] = [None if isinstance(proj, nn.Identity)
                               else {"w": _np(proj.weight, True)}
                               for proj in model.res_projs]
    if model.time_emb is not None:
        params["time_emb"] = _np(model.time_emb)
    return params, state
