"""Feature-only baselines (port of elliptic_gnn_tpu/train/train_baselines.py):
logistic regression and gradient-boosted trees, with the same config keys,
the same run-dir artifacts as the GNN path (so every analysis tool reads a
baseline run), and the same split handling: labeled rows only, split
bounds re-derived from the stored masks' timesteps.

  - the gradient-boosting engine is XGBoost when it imports, else sklearn
    HistGradientBoostingClassifier (config key `model: xgboost` either way);
    metrics.json records the engine;
  - class imbalance: scale_pos_weight='auto' -> neg/pos on train; LR uses
    the `class_weight` key directly;
  - `calibration: isotonic | platt | none`, fit on val.

Host only (numpy and sklearn): the baselines touch no GPU.

CLI: python -m elliptic_gnn_tpu_torch.train.train_baselines --config configs/baseline_xgb.yaml
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Tuple

import numpy as np
import yaml

from ..graph import load_processed
from ..utils.common import ensure_dir, save_json, set_seed
from ..utils import metrics as M
from . import calibrate


def get_split_arrays(data, train_window_k=None) -> Tuple:
    """Labeled rows only; split bounds re-derived from the stored masks'
    timesteps, with optional rolling window."""
    t = data.timestep
    t_train_end = int(t[data.train_mask].max())
    t_val_end = int(t[data.val_mask].max())

    labeled = data.y >= 0
    train = labeled & (t <= t_train_end)
    if train_window_k is not None:
        t_lo = max(1, t_train_end - int(train_window_k) + 1)
        train = labeled & (t >= t_lo) & (t <= t_train_end)
    val = labeled & (t > t_train_end) & (t <= t_val_end)
    test = labeled & (t > t_val_end)
    return train, val, test


def fit_model(cfg: dict, x_tr, y_tr, x_val, y_val, seed: int):
    """Returns (fitted_model, engine_name)."""
    kind = str(cfg.get("model", "logistic_regression"))
    if kind in ("logistic_regression", "lr"):
        from sklearn.linear_model import LogisticRegression
        from sklearn.pipeline import Pipeline
        from sklearn.preprocessing import StandardScaler

        pipe = Pipeline([
            ("scaler", StandardScaler()),
            ("clf", LogisticRegression(
                C=float(cfg.get("C", 1.0)),
                max_iter=int(cfg.get("max_iter", 2000)),
                class_weight=cfg.get("class_weight", "balanced"),
                random_state=seed,
            )),
        ])
        pipe.fit(x_tr, y_tr)
        return pipe, "sklearn_logreg"

    if kind in ("xgboost", "xgb"):
        spw = cfg.get("scale_pos_weight", "auto")
        if spw == "auto":
            pos = max(int((y_tr == 1).sum()), 1)
            spw = float((y_tr == 0).sum()) / pos
        try:
            import inspect

            from xgboost import XGBClassifier

            params = dict(
                n_estimators=int(cfg.get("n_estimators", 1000)),
                max_depth=int(cfg.get("max_depth", 4)),
                learning_rate=float(cfg.get("learning_rate", 0.05)),
                min_child_weight=float(cfg.get("min_child_weight", 5)),
                subsample=float(cfg.get("subsample", 0.8)),
                colsample_bytree=float(cfg.get("colsample_bytree", 0.8)),
                eval_metric=cfg.get("eval_metric", "aucpr"),
                scale_pos_weight=float(spw),
                random_state=seed,
                n_jobs=int(cfg.get("n_jobs", -1)),
            )
            esr = cfg.get("early_stopping_rounds")
            clf = XGBClassifier(**params)
            fit_kwargs = {"eval_set": [(x_val, y_val)], "verbose": False}
            # version-adaptive early stopping: constructor kwarg on new
            # versions, fit kwarg on old
            if esr is not None:
                if "early_stopping_rounds" in inspect.signature(
                    XGBClassifier.__init__
                ).parameters:
                    clf = XGBClassifier(**params, early_stopping_rounds=int(esr))
                else:
                    fit_kwargs["early_stopping_rounds"] = int(esr)
            clf.fit(x_tr, y_tr, **fit_kwargs)
            return clf, "xgboost"
        except ImportError:
            from sklearn.ensemble import HistGradientBoostingClassifier

            clf = HistGradientBoostingClassifier(
                max_iter=int(cfg.get("n_estimators", 1000)),
                max_depth=int(cfg.get("max_depth", 4)),
                learning_rate=float(cfg.get("learning_rate", 0.05)),
                early_stopping=True,
                n_iter_no_change=int(cfg.get("early_stopping_rounds", 50)),
                validation_fraction=0.15,
                random_state=seed,
            )
            w = np.where(y_tr == 1, float(spw), 1.0)
            clf.fit(x_tr, y_tr, sample_weight=w)
            return clf, "sklearn_histgb"

    raise ValueError(f"unknown baseline model {kind!r}")


def main(cfg: dict) -> dict:
    seed = int(cfg.get("seed", 42))
    set_seed(seed)
    outdir = os.path.join(
        cfg.get("output_root", "outputs"), "baselines", cfg["run_name"]
    )
    ensure_dir(outdir)

    data = load_processed(cfg["processed_dir"])
    if data.train_mask is None:
        raise RuntimeError("Build graph first (graph.npz has no masks)")

    train, val, test = get_split_arrays(data, cfg.get("train_window_k"))
    x, y = data.x, data.y
    x_tr, y_tr = x[train], y[train]
    x_val, y_val = x[val], y[val]
    x_te, y_te = x[test], y[test]
    print(f"[BAL] train={len(y_tr)} (pos={int((y_tr==1).sum())}) "
          f"val={len(y_val)} test={len(y_te)}")

    model, engine = fit_model(cfg, x_tr, y_tr, x_val, y_val, seed)
    with open(os.path.join(outdir, "model.pkl"), "wb") as f:
        pickle.dump(model, f)

    p_val = model.predict_proba(x_val)[:, 1]
    p_te = model.predict_proba(x_te)[:, 1]

    # optional isotonic/Platt calibration fit on val
    cal_kind = str(cfg.get("calibration", "none"))
    if cal_kind == "isotonic":
        cal = calibrate.calibrate_isotonic(p_val, (y_val == 1).astype(int))
        p_val = calibrate.apply_sklearn_calibrator(cal, p_val)
        p_te = calibrate.apply_sklearn_calibrator(cal, p_te)
    elif cal_kind == "platt":
        cal = calibrate.calibrate_platt(p_val, (y_val == 1).astype(int))
        p_val = calibrate.apply_sklearn_calibrator(cal, p_val)
        p_te = calibrate.apply_sklearn_calibrator(cal, p_te)

    # artifacts (same contract as the GNN path)
    np.save(os.path.join(outdir, "scores_val.npy"), p_val)
    np.save(os.path.join(outdir, "y_val.npy"), y_val)
    np.save(os.path.join(outdir, "node_idx_val.npy"), np.where(val)[0])
    np.save(os.path.join(outdir, "timestep_val.npy"), data.timestep[val])
    np.save(os.path.join(outdir, "scores_test.npy"), p_te)
    np.save(os.path.join(outdir, "y_test.npy"), y_te)
    np.save(os.path.join(outdir, "node_idx_test.npy"), np.where(test)[0])
    np.save(os.path.join(outdir, "timestep_test.npy"), data.timestep[test])

    yv_bin = (y_val == 1).astype(int)
    if cfg.get("use_val_for_thresholds", True):
        pt = float(cfg.get("precision_target", 0.0) or 0.0)
        if pt > 0:
            thr = M.pick_threshold_for_precision(yv_bin, p_val, pt)
        else:
            thr, _ = M.pick_threshold_max_f1(yv_bin, p_val)
    else:
        thr, _ = M.pick_threshold_max_f1((y_te == 1).astype(int), p_te)

    y_bin = (y_te == 1).astype(int)
    metrics = dict(
        pr_auc_illicit=M.pr_auc_illicit(y_bin, p_te),
        roc_auc=M.roc_auc_illicit(y_bin, p_te),
        f1_illicit_at_thr=M.f1_at_threshold(y_bin, p_te, thr),
        threshold=float(thr),
        precision_at_k=M.precision_at_k(y_bin, p_te, int(cfg.get("topk", 100))),
        recall_at_precision=M.recall_at_precision(
            y_bin, p_te, float(cfg.get("precision_target", 0.90) or 0.90)
        ),
        ece=M.expected_calibration_error(y_bin, p_te),
        n_test=int(len(y_te)),
        best_val_pr_auc=M.pr_auc_illicit(yv_bin, p_val),
        engine=engine,
        calibration=cal_kind,
    )
    _, pr_by_t = M.per_timestep_pr_auc(y_bin, p_te, data.timestep[test])
    metrics["test_pr_auc_by_time"] = pr_by_t
    if pr_by_t:
        metrics["pr_auc_last1"] = float(pr_by_t[-1])
        metrics.update(M.tail_means(pr_by_t, ks=(3, 5)))

    save_json(os.path.join(outdir, "metrics.json"), metrics)
    with open(os.path.join(outdir, "config_used.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args()
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    main(cfg)
