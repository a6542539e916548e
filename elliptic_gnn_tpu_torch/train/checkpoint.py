"""Checkpointing (port of elliptic_gnn_tpu/train/checkpoint.py): the best
snapshot and the mid-training resume, both in the JAX package's layout.

`best.ckpt` is a flat npz of the best model's parameters and BatchNorm
state, {"params/...": ..., "state/...": ...}, each key the '/'-joined path
of an array in the JAX model's pytrees (models/convert.py::params_to_jax),
e.g. params/layers/0/w_l, params/bns/1/scale, params/res_projs/1/w,
state/bns/0/mean. The JAX package's tools read a port run's best.ckpt, and
the port's train/predict.py and analysis/common.py read a JAX run's.

`resume.ckpt` (save_resume / load_resume) holds params, state, opt_state,
best_params and best_state plus the scalars __scalar__/epoch, best_val and
bad. opt_state is the state of the JAX trainer's optax chain
(train_gnn.make_optimizer there): clip_by_global_norm (when grad_clip > 0)
and add_decayed_weights (when weight_decay > 0), both without arrays, then
scale_by_adam as {count, mu, nu}, then scale; torch Adam's step,
exp_avg and exp_avg_sq map onto count, mu and nu at the chain index of
scale_by_adam. The port adds rng/dropout, its dropout generator's state,
which the JAX package ignores (it restarts its key on a resume); a file
without it restarts the port's generator from the seed in the same way.
Either package resumes from the other's file.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
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
        raise KeyError(f"checkpoint has no entry {prefix}")
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


def _by_id(model: nn.Module, tensors: Dict[str, torch.Tensor]):
    """A map from each of the module's tensors to its namesake in
    `tensors` (a state_dict-keyed dict)."""
    own = {id(t): k for k, t in model.state_dict(keep_vars=True).items()}
    return lambda t: tensors[own[id(t)]]


def adam_index(cfg: dict) -> int:
    """Index of scale_by_adam in the JAX trainer's optax chain."""
    return (int(float(cfg.get("grad_clip", 0) or 0) > 0)
            + int(float(cfg.get("weight_decay", 0.0)) > 0))


def _moment(opt_state, name: str):
    """A map from each parameter to its Adam moment `name` in `opt_state`
    (torch Adam's per-parameter state); BN buffers, which have none, map
    to themselves."""
    def take(t):
        st = opt_state.get(t)
        return st[name] if st else t
    return take


def _opt_tree(model: nn.Module, opt_state, cfg: dict) -> list:
    """torch Adam's state as the optax chain's state pytree."""
    params = list(model.parameters())
    state = [opt_state.get(p, {}) for p in params]
    if any("exp_avg" not in st for st in state):
        raise ValueError("the optimizer has not stepped: no Adam state to save")
    steps = {float(st["step"]) for st in state}
    if len(steps) != 1:
        raise ValueError(f"Adam steps differ between parameters: {sorted(steps)}")
    chain = [{} for _ in range(adam_index(cfg) + 2)]
    chain[adam_index(cfg)] = {
        "count": np.asarray(int(steps.pop()), np.int32),
        "mu": params_to_jax(model, take=_moment(opt_state, "exp_avg"))[0],
        "nu": params_to_jax(model, take=_moment(opt_state, "exp_avg_sq"))[0],
    }
    return chain


def save_resume(outdir: str, model: nn.Module, opt_state, cfg: dict,
                epoch: int, best_val: float, bad: int,
                best: Optional[Dict[str, torch.Tensor]] = None,
                rng_state: Optional[torch.Tensor] = None,
                current: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """resume.ckpt after `epoch`: the model (or `current`, a state_dict-keyed
    snapshot of it), torch Adam's per-parameter state `opt_state`
    (optimizer.state or a snapshot of it), and `best`, the best model as a
    state_dict-keyed dict, so that a resumed run whose later epochs never
    beat best_val still ends with the true best model."""
    params, state = params_to_jax(
        model, take=None if current is None else _by_id(model, current))
    tree = {"params": params, "state": state,
            "opt_state": _opt_tree(model, opt_state, cfg)}
    if best is not None:
        tree["best_params"], tree["best_state"] = params_to_jax(
            model, take=_by_id(model, best))
    flat = flatten(tree)
    flat.update({"__scalar__/epoch": np.asarray(epoch),
                 "__scalar__/best_val": np.asarray(best_val),
                 "__scalar__/bad": np.asarray(bad)})
    if rng_state is not None:
        flat["rng/dropout"] = rng_state.cpu().numpy()
    path = os.path.join(outdir, "resume.ckpt")
    with open(path + ".tmp", "wb") as fh:
        np.savez(fh, **flat)
    os.replace(path + ".tmp", path)


def _set_adam(model: nn.Module, opt: torch.optim.Adam, adam: dict) -> None:
    """Adam's per-parameter state from the optax {count, mu, nu}."""
    params = [p for g in opt.param_groups for p in g["params"]]
    moments = {name: {p: torch.zeros_like(p, memory_format=torch.preserve_format)
                      for p in params} for name in ("exp_avg", "exp_avg_sq")}
    for name, tree in (("exp_avg", adam["mu"]), ("exp_avg_sq", adam["nu"])):
        params_from_jax(tree, None, model, put=lambda p, m=moments[name]: m[p])
    capturable = any(g.get("capturable") or g.get("fused") for g in opt.param_groups)
    count = float(np.asarray(adam["count"]))
    for p in params:
        st = opt.state[p]
        step = torch.tensor(count, dtype=torch.float32,
                            device=p.device if capturable else "cpu")
        for key, value in (("step", step), ("exp_avg", moments["exp_avg"][p]),
                           ("exp_avg_sq", moments["exp_avg_sq"][p])):
            if key in st:
                st[key].copy_(value)
            else:
                st[key] = value


def load_resume(outdir: str, model: nn.Module, opt: torch.optim.Adam, cfg: dict,
                best: Dict[str, torch.Tensor]) -> Tuple[int, float, int, Optional[torch.Tensor]]:
    """Loads resume.ckpt into the model, the optimizer and `best` (a
    state_dict-keyed dict of the best model's tensors), in place. Returns
    (epoch, best_val, bad, dropout generator state or None). A file written
    before best-model tracking restores best = current and best_val = -1,
    so that the best is established again rather than silently mismatched."""
    path = os.path.join(outdir, "resume.ckpt")
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    params_t, state_t = params_to_jax(model)
    i = adam_index(cfg)
    adam_t = {"count": np.zeros((), np.int32), "mu": params_t, "nu": params_t}
    tree = _fill({"params": params_t, "state": state_t,
                  "opt_state": {str(i): adam_t}}, flat)
    params_from_jax(tree["params"], tree["state"], model)
    _set_adam(model, opt, tree["opt_state"][str(i)])
    try:
        best_tree = _fill({"best_params": params_t, "best_state": state_t}, flat)
        best_val = float(flat["__scalar__/best_val"])
    except KeyError:
        best_tree, best_val = None, -1.0
    if best_tree is None:
        with torch.no_grad():
            for k, t in model.state_dict().items():
                best[k].copy_(t)
    else:
        params_from_jax(best_tree["best_params"], best_tree["best_state"], model,
                        put=_by_id(model, best))
    rng = flat.get("rng/dropout")
    return (int(flat["__scalar__/epoch"]), best_val, int(flat["__scalar__/bad"]),
            None if rng is None else torch.from_numpy(rng))


def has_resume(outdir: str) -> bool:
    return os.path.exists(os.path.join(outdir, "resume.ckpt"))
