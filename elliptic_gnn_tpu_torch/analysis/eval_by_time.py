"""Temporal drift analysis (port of elliptic_gnn_tpu/analysis/eval_by_time.py):
per-timestep PR-AUC + F1 at the trained threshold -> by_time.csv +
by_time_pr_auc.png in the run dir. Host only: it reads the run's
scores_test.npy and metrics.json.

CLI: python -m elliptic_gnn_tpu_torch.analysis.eval_by_time --run_dir outputs/gnn/<run>
"""
from __future__ import annotations

import argparse
import csv
import os
from typing import List

import numpy as np

from ..utils import metrics as M
from .common import load_run_arrays, load_run_metrics, pyplot


def compute_metrics_per_timestep(
    y: np.ndarray, scores: np.ndarray, timesteps: np.ndarray, threshold: float
) -> List[dict]:
    rows = []
    for t in sorted(set(int(v) for v in np.unique(timesteps))):
        m = timesteps == t
        y_t = (y[m] == 1).astype(int)
        s_t = scores[m]
        if y_t.size == 0 or y_t.sum() == 0:
            pr = float("nan")
        else:
            pr = M.pr_auc_illicit(y_t, s_t)
        rows.append({
            "timestep": t,
            "n": int(m.sum()),
            "n_illicit": int(y_t.sum()),
            "pr_auc": pr,
            "f1_at_thr": M.f1_at_threshold(y_t, s_t, threshold),
        })
    return rows


def main(run_dir: str) -> None:
    metrics = load_run_metrics(run_dir)
    thr = float(metrics["threshold"])
    arr = load_run_arrays(run_dir, "test")
    rows = compute_metrics_per_timestep(
        arr["y"], arr["scores"], arr["timestep"], thr
    )

    out_csv = os.path.join(run_dir, "by_time.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["timestep", "n", "n_illicit", "pr_auc", "f1_at_thr"])
        w.writeheader()
        w.writerows(rows)

    png = os.path.join(run_dir, "by_time_pr_auc.png")
    plt = pyplot(png, "BY_TIME")
    if plt is None:
        return
    ts = [r["timestep"] for r in rows]
    pr = [r["pr_auc"] for r in rows]
    plt.figure(figsize=(7, 4))
    plt.plot(ts, pr, marker="o")
    plt.xlabel("timestep")
    plt.ylabel("PR-AUC (illicit)")
    plt.title(f"Test PR-AUC by timestep (thr={thr:.3f})")
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(png, dpi=200)
    plt.close()
    print(f"[BY_TIME] wrote {out_csv} and by_time_pr_auc.png")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_dir", type=str, required=True)
    args = parser.parse_args()
    main(args.run_dir)
