"""Reliability diagram (port of elliptic_gnn_tpu/analysis/calibration_plots.py):
accuracy bars vs confidence per probability bin (15 equal-width bins, the
last closed on the right), with ECE in the title -> calibration_curve.png.
Host only.

CLI: python -m elliptic_gnn_tpu_torch.analysis.calibration_plots --run_dir <dir>
         [--split test] [--bins 15]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils import metrics as M
from .common import load_run_arrays, pyplot


def compute_reliability(y: np.ndarray, scores: np.ndarray, bins: int = 15):
    """Per-bin (confidence, accuracy, count); empty bins -> NaN."""
    edges = np.linspace(0.0, 1.0, bins + 1)
    conf = np.full(bins, np.nan)
    acc = np.full(bins, np.nan)
    cnt = np.zeros(bins, dtype=np.int64)
    for i in range(bins):
        lo, hi = edges[i], edges[i + 1]
        if i < bins - 1:
            m = (scores >= lo) & (scores < hi)
        else:
            m = (scores >= lo) & (scores <= hi)
        cnt[i] = m.sum()
        if cnt[i]:
            conf[i] = scores[m].mean()
            acc[i] = (y[m] == 1).mean()
    return edges, conf, acc, cnt


def main(run_dir: str, split: str = "test", bins: int = 15) -> None:
    arr = load_run_arrays(run_dir, split)
    y, s = arr["y"], arr["scores"]
    y_bin = (y == 1).astype(int)
    ece = M.expected_calibration_error(y_bin, s, bins=bins)
    edges, conf, acc, cnt = compute_reliability(y, s, bins)

    out = os.path.join(run_dir, "calibration_curve.png")
    plt = pyplot(out, "CALIB")
    if plt is None:
        print(f"[CALIB] ECE={ece:.4f}")
        return
    centers = (edges[:-1] + edges[1:]) / 2
    width = edges[1] - edges[0]
    plt.figure(figsize=(6, 5))
    plt.bar(centers, np.nan_to_num(acc), width=width * 0.9, alpha=0.7,
            label="accuracy")
    plt.plot(centers, conf, "r.-", label="confidence")
    plt.plot([0, 1], [0, 1], "k--", alpha=0.5, label="perfect")
    plt.xlabel("predicted probability")
    plt.ylabel("empirical frequency")
    plt.title(f"Reliability ({split}); ECE={ece:.4f}")
    plt.legend()
    plt.tight_layout()
    plt.savefig(out, dpi=200)
    plt.close()
    print(f"[CALIB] ECE={ece:.4f}; wrote {out}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_dir", type=str, required=True)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--bins", type=int, default=15)
    args = parser.parse_args()
    main(args.run_dir, args.split, args.bins)
