"""Exact TreeSHAP for sklearn HistGradientBoosting and XGBoost models
(copy of elliptic_gnn_tpu/analysis/treeshap.py: numpy only).

The exact algorithm of Lundberg et al. 2018 ("Consistent Individualized
Feature Attribution for Tree Ensembles", Algorithm 2), without the `shap`
package, over a neutral internal tree encoding with adapters for both
gradient-boosting engines train_baselines.py can produce:

  - sklearn HistGradientBoostingClassifier (`hist_gb_shap_values`): walks
    `model._predictors` node arrays directly;
  - XGBoost (`xgb_shap_values` / `xgb_json_shap_values`): walks the
    booster's `get_dump(dump_format="json", with_stats=True)` trees, with
    XGBoost split semantics (strict `x < threshold`, explicit missing
    branch, hessian `cover` as node weights) and `logit(base_score)` as
    the margin-space base value. `xgb_json_shap_values` takes the dump
    strings themselves, so it is testable without xgboost installed.

Local accuracy: sum(phi) + expected_value equals the model's raw decision
value for every sample, to float precision. Attributions are in raw
log-odds (margin) space, as shap.TreeExplainer's default for binary
classifiers.
"""
from __future__ import annotations

import json
import math
from typing import List, Sequence

import numpy as np

# Engine-neutral node encoding. `strict` selects the split comparison:
# False -> x <= threshold goes left (sklearn HistGB); True -> x < threshold
# goes left (XGBoost). `left` is always the hot branch for a satisfied
# condition ("yes" child in XGBoost dumps); `missing_left` routes NaNs.
_NODE_DT = np.dtype([
    ("left", np.int64),
    ("right", np.int64),
    ("feature_idx", np.int64),
    ("threshold", np.float64),
    ("missing_left", np.bool_),
    ("is_leaf", np.bool_),
    ("value", np.float64),
    ("count", np.float64),
    ("depth", np.int64),
    ("strict", np.bool_),
])


class _Path:
    """Decision-path state for TreeSHAP: parallel arrays of feature index,
    zero fraction, one fraction, and Shapley path weight."""

    __slots__ = ("d", "z", "o", "w", "n")

    def __init__(self, cap: int):
        self.d = np.empty(cap, np.int64)
        self.z = np.empty(cap, np.float64)
        self.o = np.empty(cap, np.float64)
        self.w = np.empty(cap, np.float64)
        self.n = 0

    def copy(self) -> "_Path":
        p = _Path(self.d.shape[0])
        n = self.n
        p.d[:n] = self.d[:n]
        p.z[:n] = self.z[:n]
        p.o[:n] = self.o[:n]
        p.w[:n] = self.w[:n]
        p.n = n
        return p


def _extend(m: _Path, pz: float, po: float, pi: int) -> None:
    l = m.n
    m.d[l] = pi
    m.z[l] = pz
    m.o[l] = po
    m.w[l] = 1.0 if l == 0 else 0.0
    m.n = l + 1
    for i in range(l - 1, -1, -1):
        m.w[i + 1] += po * m.w[i] * (i + 1) / (l + 1)
        m.w[i] = pz * m.w[i] * (l - i) / (l + 1)


def _unwind(m: _Path, i: int) -> None:
    l = m.n - 1
    o_i, z_i = m.o[i], m.z[i]
    nxt = m.w[l]
    if o_i != 0.0:
        for j in range(l - 1, -1, -1):
            t = nxt * (l + 1) / ((j + 1) * o_i)
            nxt = m.w[j] - t * z_i * (l - j) / (l + 1)
            m.w[j] = t
    else:
        for j in range(l - 1, -1, -1):
            m.w[j] = m.w[j] * (l + 1) / (z_i * (l - j))
    for j in range(i, l):
        m.d[j] = m.d[j + 1]
        m.z[j] = m.z[j + 1]
        m.o[j] = m.o[j + 1]
    m.n = l


def _unwound_sum(m: _Path, i: int) -> float:
    """Sum of path weights after hypothetically unwinding element i."""
    l = m.n - 1
    o_i, z_i = m.o[i], m.z[i]
    total = 0.0
    nxt = m.w[l]
    if o_i != 0.0:
        for j in range(l - 1, -1, -1):
            t = nxt * (l + 1) / ((j + 1) * o_i)
            total += t
            nxt = m.w[j] - t * z_i * (l - j) / (l + 1)
    else:
        for j in range(l - 1, -1, -1):
            total += m.w[j] * (l + 1) / (z_i * (l - j))
    return total


def _tree_shap(nodes: np.ndarray, x: np.ndarray, phi: np.ndarray) -> None:
    """Accumulate exact SHAP values of one tree (internal encoding) for
    sample x."""
    max_depth = int(nodes["depth"].max()) + 2

    def recurse(j: int, m: _Path, pz: float, po: float, pi: int) -> None:
        m = m.copy()
        _extend(m, pz, po, pi)
        nd = nodes[j]
        if nd["is_leaf"]:
            v = float(nd["value"])
            for i in range(1, m.n):
                w = _unwound_sum(m, i)
                phi[m.d[i]] += w * (m.o[i] - m.z[i]) * v
            return
        f = int(nd["feature_idx"])
        xv = x[f]
        if np.isnan(xv):
            goes_left = bool(nd["missing_left"])
        elif nd["strict"]:
            goes_left = xv < nd["threshold"]
        else:
            goes_left = xv <= nd["threshold"]
        hot, cold = (
            (int(nd["left"]), int(nd["right"]))
            if goes_left
            else (int(nd["right"]), int(nd["left"]))
        )
        iz = io = 1.0
        k = -1
        for i in range(1, m.n):
            if m.d[i] == f:
                k = i
                break
        if k >= 0:
            iz, io = float(m.z[k]), float(m.o[k])
            _unwind(m, k)
        r_j = float(nodes[j]["count"])
        recurse(hot, m, iz * nodes[hot]["count"] / r_j, io, f)
        recurse(cold, m, iz * nodes[cold]["count"] / r_j, 0.0, f)

    recurse(0, _Path(max_depth + 2), 1.0, 1.0, -1)


def _leaf_mean(nodes: np.ndarray) -> float:
    """Coverage-weighted mean leaf value = the tree's unconditional
    expectation under the count/cover measure."""
    leaf = nodes["is_leaf"]
    return float(
        (nodes["value"][leaf] * nodes["count"][leaf]).sum()
        / nodes["count"][0]
    )


def _shap_ensemble(trees: Sequence[np.ndarray], X: np.ndarray,
                   base: float):
    X = np.asarray(X, np.float64)
    n, f = X.shape
    phi = np.zeros((n, f), np.float64)
    expected = float(base)
    for nodes in trees:
        expected += _leaf_mean(nodes)
        for i in range(n):
            _tree_shap(nodes, X[i], phi[i])
    return phi, expected


# ----------------------------------------------------- HistGB adapter ----

def _histgb_to_nodes(nodes) -> np.ndarray:
    """sklearn HistGB predictor node array -> internal encoding
    (split: x <= num_threshold goes left; count = sample count)."""
    out = np.zeros(len(nodes), _NODE_DT)
    out["left"] = nodes["left"]
    out["right"] = nodes["right"]
    out["feature_idx"] = nodes["feature_idx"]
    out["threshold"] = nodes["num_threshold"]
    out["missing_left"] = nodes["missing_go_to_left"].astype(bool)
    out["is_leaf"] = nodes["is_leaf"].astype(bool)
    out["value"] = nodes["value"]
    out["count"] = nodes["count"]
    out["depth"] = nodes["depth"]
    out["strict"] = False
    return out


def hist_gb_shap_values(model, X: np.ndarray):
    """Exact TreeSHAP values for a fitted HistGradientBoostingClassifier.

    Returns (phi [n, F] float64 in raw log-odds space, expected_value
    float). Additivity: phi.sum(1) + expected_value == decision_function(X).
    """
    predictors = model._predictors
    if any(
        p.nodes["is_categorical"].any() for row in predictors for p in row
    ):
        raise ValueError("categorical splits unsupported")
    if len(predictors[0]) != 1:
        raise ValueError("binary classification expected (1 tree per iter)")
    trees = [_histgb_to_nodes(row[0].nodes) for row in predictors]
    base = float(np.ravel(model._baseline_prediction)[0])
    return _shap_ensemble(trees, X, base)


# ---------------------------------------------------- XGBoost adapter ----

def _feat_index(split, feature_names) -> int:
    """Resolve an XGBoost dump's `split` field ("f12" or a real feature
    name when feature_names were attached) to a column index."""
    if feature_names and split in feature_names:
        return feature_names.index(split)
    s = str(split)
    if s.startswith("f") and s[1:].isdigit():
        return int(s[1:])
    raise ValueError(f"cannot resolve split feature {split!r}")


def _xgb_json_to_nodes(tree: dict, feature_names=None) -> np.ndarray:
    """One tree of booster.get_dump(dump_format="json", with_stats=True)
    -> internal encoding. XGBoost semantics: x < split_condition goes to
    the `yes` child, NaN to the `missing` child, `cover` (hessian sum;
    children sum to parent) as node weights — identical to what
    shap.TreeExplainer uses for XGBoost."""
    flat: List[dict] = []

    def walk(nd: dict, depth: int):
        nd = dict(nd)
        nd["_depth"] = depth
        flat.append(nd)
        for ch in nd.get("children", ()):
            walk(ch, depth + 1)

    walk(tree, 0)
    by_id = {int(nd["nodeid"]): i for i, nd in enumerate(flat)}
    out = np.zeros(len(flat), _NODE_DT)
    out["strict"] = True
    for i, nd in enumerate(flat):
        out["depth"][i] = nd["_depth"]
        out["count"][i] = float(nd.get("cover", 1.0))
        if "leaf" in nd:
            out["is_leaf"][i] = True
            out["value"][i] = float(nd["leaf"])
            continue
        yes, no = by_id[int(nd["yes"])], by_id[int(nd["no"])]
        out["left"][i] = yes
        out["right"][i] = no
        out["feature_idx"][i] = _feat_index(nd["split"], feature_names)
        out["threshold"][i] = float(nd["split_condition"])
        out["missing_left"][i] = by_id[int(nd["missing"])] == yes
    if by_id.get(int(flat[0]["nodeid"])) != 0:
        raise ValueError("root must be node 0")
    return out


def xgb_json_shap_values(dumps: Sequence[str], X: np.ndarray,
                         base_margin: float, feature_names=None):
    """Exact TreeSHAP from XGBoost JSON dump strings (the output of
    `booster.get_dump(dump_format="json", with_stats=True)`).

    base_margin is the margin-space bias (logit(base_score) for
    binary:logistic). Additivity: phi.sum(1) + expected_value ==
    predict(output_margin=True)."""
    trees = [
        _xgb_json_to_nodes(json.loads(d), feature_names) for d in dumps
    ]
    return _shap_ensemble(trees, X, base_margin)


def xgb_base_margin(booster) -> float:
    """Margin-space bias of a booster: logit(base_score) for logistic
    objectives, base_score itself otherwise (XGBoost stores base_score in
    probability space for binary:logistic)."""
    cfg = json.loads(booster.save_config())
    learner = cfg["learner"]
    base = float(learner["learner_model_param"]["base_score"])
    objective = learner.get("objective", {}).get("name", "") or \
        learner.get("learner_train_param", {}).get("objective", "")
    if "logistic" in objective:
        base = min(max(base, 1e-12), 1 - 1e-12)
        return math.log(base / (1.0 - base))
    return base


def xgb_shap_values(model, X: np.ndarray):
    """Exact TreeSHAP values for a fitted XGBClassifier (binary).

    Returns (phi [n, F] float64 in margin/log-odds space, expected_value
    float). Additivity: phi.sum(1) + expected_value ==
    model.predict(X, output_margin=True)."""
    booster = model.get_booster()
    dumps = booster.get_dump(dump_format="json", with_stats=True)
    return xgb_json_shap_values(
        dumps, X, xgb_base_margin(booster), booster.feature_names
    )
