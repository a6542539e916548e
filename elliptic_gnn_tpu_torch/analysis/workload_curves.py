"""Analyst-workload curve (port of elliptic_gnn_tpu/analysis/workload_curves.py):
Precision@K over a K grid from 10 to k_max, by a cumulative sum over the
score-sorted labels -> workload_curve.csv + workload_curve.png. Host only.

CLI: python -m elliptic_gnn_tpu_torch.analysis.workload_curves --run_dir <dir>
         [--k_max 5000]
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from .common import load_run_arrays, pyplot


def compute_precision_curve(y: np.ndarray, scores: np.ndarray, k_values):
    order = np.argsort(-scores)
    sorted_y = (y[order] == 1).astype(np.float64)
    cum = np.cumsum(sorted_y)
    out = []
    for k in k_values:
        k_eff = min(int(k), sorted_y.size)
        out.append((int(k), float(cum[k_eff - 1] / k_eff) if k_eff else float("nan")))
    return out


def build_k_values(n: int, k_max: int):
    k_max = min(int(k_max), n)
    ks = list(range(10, k_max + 1, 10))
    if not ks or ks[-1] != k_max:
        ks.append(k_max)
    return ks


def main(run_dir: str, k_max: int = 5000) -> None:
    arr = load_run_arrays(run_dir, "test")
    ks = build_k_values(arr["y"].size, k_max)
    curve = compute_precision_curve(arr["y"], arr["scores"], ks)

    out_csv = os.path.join(run_dir, "workload_curve.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["k", "precision_at_k"])
        w.writerows(curve)

    png = os.path.join(run_dir, "workload_curve.png")
    plt = pyplot(png, "WORKLOAD")
    if plt is None:
        return
    plt.figure(figsize=(7, 4))
    plt.plot([c[0] for c in curve], [c[1] for c in curve])
    plt.xlabel("K (cases reviewed)")
    plt.ylabel("Precision@K")
    plt.title("Analyst workload curve (test)")
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(png, dpi=200)
    plt.close()
    print(f"[WORKLOAD] wrote {out_csv} and workload_curve.png")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_dir", type=str, required=True)
    parser.add_argument("--k_max", type=int, default=5000)
    args = parser.parse_args()
    main(args.run_dir, args.k_max)
