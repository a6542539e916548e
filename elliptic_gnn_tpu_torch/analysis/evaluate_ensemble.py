"""Two-run ensembling (port of elliptic_gnn_tpu/analysis/evaluate_ensemble.py):
average probabilities (or logits), pick the threshold again on the
ensembled validation scores, and write a full run-shaped output directory.
  - both runs are aligned by node_idx per split and must cover the same
    node sets (asserted);
  - mode 'prob' averages probabilities, 'logit' averages logit(p) then
    applies the sigmoid;
  - the output dir mirrors a normal run (metrics.json incl. per-timestep
    tails, scores/y/node_idx/timestep npys, minimal config echo) so every
    downstream tool can read it unchanged.
Host only.

CLI: python -m elliptic_gnn_tpu_torch.analysis.evaluate_ensemble
         --run_a <dir> --run_b <dir> --out_dir <dir>
         [--mode logit|prob] [--topk 100] [--precision_target 0.0]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import yaml

from ..utils import metrics as M
from ..utils.common import ensure_dir, save_json
from .common import load_run_arrays


def _logit(p: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    p = np.clip(p, eps, 1 - eps)
    return np.log(p / (1 - p))


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-z))


def _align(a, b, split: str):
    ia = np.argsort(a["node_idx"])
    ib = np.argsort(b["node_idx"])
    a = {k: v[ia] for k, v in a.items()}
    b = {k: v[ib] for k, v in b.items()}
    if not np.array_equal(a["node_idx"], b["node_idx"]):
        raise AssertionError(f"{split}: run node sets differ; cannot ensemble")
    if not np.array_equal(a["y"], b["y"]):
        raise AssertionError(f"{split}: labels disagree between runs")
    return a, b


def _ensemble(pa: np.ndarray, pb: np.ndarray, mode: str) -> np.ndarray:
    if mode == "prob":
        return (pa + pb) / 2.0
    if mode == "logit":
        return _sigmoid((_logit(pa) + _logit(pb)) / 2.0)
    raise ValueError(f"unknown ensemble mode {mode!r}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_a", type=str, required=True)
    ap.add_argument("--run_b", type=str, required=True)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--mode", type=str, default="logit", choices=["logit", "prob"])
    ap.add_argument("--topk", type=int, default=100)
    ap.add_argument("--precision_target", type=float, default=0.0)
    args = ap.parse_args(argv)

    va, vb = _align(
        load_run_arrays(args.run_a, "val"), load_run_arrays(args.run_b, "val"), "val"
    )
    ta, tb = _align(
        load_run_arrays(args.run_a, "test"), load_run_arrays(args.run_b, "test"), "test"
    )

    p_val = _ensemble(va["scores"], vb["scores"], args.mode)
    p_te = _ensemble(ta["scores"], tb["scores"], args.mode)
    y_val, y_te = va["y"], ta["y"]

    # threshold on the ensembled val scores
    yv_bin = (y_val == 1).astype(int)
    if args.precision_target > 0:
        thr = M.pick_threshold_for_precision(yv_bin, p_val, args.precision_target)
    else:
        thr, _ = M.pick_threshold_max_f1(yv_bin, p_val)

    out_dir = ensure_dir(args.out_dir)
    np.save(os.path.join(out_dir, "scores_val.npy"), p_val)
    np.save(os.path.join(out_dir, "y_val.npy"), y_val)
    np.save(os.path.join(out_dir, "node_idx_val.npy"), va["node_idx"])
    np.save(os.path.join(out_dir, "timestep_val.npy"), va["timestep"])
    np.save(os.path.join(out_dir, "scores_test.npy"), p_te)
    np.save(os.path.join(out_dir, "y_test.npy"), y_te)
    np.save(os.path.join(out_dir, "node_idx_test.npy"), ta["node_idx"])
    np.save(os.path.join(out_dir, "timestep_test.npy"), ta["timestep"])

    y_bin = (y_te == 1).astype(int)
    metrics = dict(
        pr_auc_illicit=M.pr_auc_illicit(y_bin, p_te),
        roc_auc=M.roc_auc_illicit(y_bin, p_te),
        f1_illicit_at_thr=M.f1_at_threshold(y_bin, p_te, thr),
        threshold=float(thr),
        precision_at_k=M.precision_at_k(y_bin, p_te, args.topk),
        recall_at_precision=M.recall_at_precision(
            y_bin, p_te, args.precision_target or 0.90
        ),
        ece=M.expected_calibration_error(y_bin, p_te),
        n_test=int(len(y_te)),
        ensemble_mode=args.mode,
        run_a=args.run_a,
        run_b=args.run_b,
    )
    _, pr_by_t = M.per_timestep_pr_auc(y_bin, p_te, ta["timestep"])
    metrics["test_pr_auc_by_time"] = pr_by_t
    if pr_by_t:
        metrics["pr_auc_last1"] = float(pr_by_t[-1])
        metrics.update(M.tail_means(pr_by_t, ks=(3, 5)))
    save_json(os.path.join(out_dir, "metrics.json"), metrics)

    with open(os.path.join(out_dir, "config_used.yaml"), "w") as f:
        yaml.safe_dump(
            {"run_name": os.path.basename(os.path.normpath(out_dir)),
             "ensemble_of": [args.run_a, args.run_b], "mode": args.mode},
            f,
        )
    print(f"[ENSEMBLE] pr_auc_illicit={metrics['pr_auc_illicit']:.4f} "
          f"(mode={args.mode}); wrote {out_dir}")


if __name__ == "__main__":
    main()
