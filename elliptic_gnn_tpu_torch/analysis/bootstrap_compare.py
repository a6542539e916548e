"""Paired bootstrap comparison of two runs (port of
elliptic_gnn_tpu/analysis/bootstrap_compare.py): ΔPR-AUC and ΔPrecision@K
with percentile confidence intervals.
  - runs aligned on the intersection of their node_idx_test sets;
  - n_boot resamples (with replacement) of the *paired* index set;
  - mean Δ + [2.5, 97.5] percentile CI per metric;
  - writes bootstrap_compare.json into run_b plus symmetric
    bootstrap_compare_<other>.json copies into both run dirs.
Host only.

CLI: python -m elliptic_gnn_tpu_torch.analysis.bootstrap_compare
         --run_a <dir> --run_b <dir> [--n_boot 1000] [--topk 100]
         [--seed 42] [--out_dir <dir>]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np

from ..utils import metrics as M
from .common import load_run_arrays


def align_runs(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]):
    """Restrict both runs to their common test nodes, in matching order."""
    common, ia, ib = np.intersect1d(
        a["node_idx"], b["node_idx"], return_indices=True
    )
    if common.size == 0:
        raise ValueError("runs share no test nodes")
    return (
        {k: v[ia] for k, v in a.items()},
        {k: v[ib] for k, v in b.items()},
        common,
    )


def compute_metrics(y: np.ndarray, scores: np.ndarray, topk: int) -> Dict[str, float]:
    y_bin = (y == 1).astype(int)
    return {
        "pr_auc": M.pr_auc_illicit(y_bin, scores),
        "p_at_k": M.precision_at_k(y_bin, scores, topk),
    }


def paired_bootstrap(
    y: np.ndarray,
    scores_a: np.ndarray,
    scores_b: np.ndarray,
    n_boot: int = 1000,
    topk: int = 100,
    seed: int = 42,
) -> Dict:
    rng = np.random.default_rng(seed)
    n = y.size
    d_pr, d_pk = np.empty(n_boot), np.empty(n_boot)
    y_bin = (y == 1).astype(int)
    for i in range(n_boot):
        idx = rng.integers(0, n, n)
        yb = y_bin[idx]
        if yb.sum() == 0:  # degenerate resample: no positives
            d_pr[i] = 0.0
            d_pk[i] = 0.0
            continue
        d_pr[i] = M.pr_auc_illicit(yb, scores_b[idx]) - M.pr_auc_illicit(
            yb, scores_a[idx]
        )
        d_pk[i] = M.precision_at_k(yb, scores_b[idx], topk) - M.precision_at_k(
            yb, scores_a[idx], topk
        )

    def summarize(d: np.ndarray) -> Dict[str, float]:
        return {
            "mean": float(d.mean()),
            "ci_low": float(np.percentile(d, 2.5)),
            "ci_high": float(np.percentile(d, 97.5)),
            "p_gt_0": float((d > 0).mean()),
        }

    return {"delta_pr_auc": summarize(d_pr), "delta_p_at_k": summarize(d_pk)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_a", type=str, required=True)
    parser.add_argument("--run_b", type=str, required=True)
    parser.add_argument("--n_boot", type=int, default=1000)
    parser.add_argument("--topk", type=int, default=100)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--out_dir", type=str, default=None)
    args = parser.parse_args(argv)

    a = load_run_arrays(args.run_a, "test")
    b = load_run_arrays(args.run_b, "test")
    a, b, common = align_runs(a, b)
    if not np.array_equal(a["y"], b["y"]):
        raise ValueError("aligned label vectors disagree between runs")

    result = {
        "run_a": os.path.basename(os.path.normpath(args.run_a)),
        "run_b": os.path.basename(os.path.normpath(args.run_b)),
        "n_common_test_nodes": int(common.size),
        "n_boot": args.n_boot,
        "topk": args.topk,
        "point_a": compute_metrics(a["y"], a["scores"], args.topk),
        "point_b": compute_metrics(b["y"], b["scores"], args.topk),
        **paired_bootstrap(
            a["y"], a["scores"], b["scores"], args.n_boot, args.topk, args.seed
        ),
    }
    payload = json.dumps(result, indent=2)

    with open(os.path.join(args.run_b, "bootstrap_compare.json"), "w") as f:
        f.write(payload)
    with open(
        os.path.join(args.run_b, f"bootstrap_compare_{result['run_a']}.json"), "w"
    ) as f:
        f.write(payload)
    with open(
        os.path.join(args.run_a, f"bootstrap_compare_{result['run_b']}.json"), "w"
    ) as f:
        f.write(payload)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "bootstrap_compare.json"), "w") as f:
            f.write(payload)
    print(payload)


if __name__ == "__main__":
    main()
