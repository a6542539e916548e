"""EDA + leakage checks (port of elliptic_gnn_tpu/analysis/eda.py) on a
processed graph:
  - degree_hist.csv: undirected degree distribution (both edge endpoints
    counted);
  - labels_by_time.csv: per-timestep counts of unknown/licit/illicit;
  - --assert_no_cross_time_edges: prints offending edges and exits 1 on
    violation, the guarantee every temporal split depends on.
Host only.

CLI: python -m elliptic_gnn_tpu_torch.analysis.eda --processed_dir data/processed
         [--out_dir <dir>] [--assert_no_cross_time_edges]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

from ..graph import load_processed
from ..utils.common import ensure_dir


def degree_histogram(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Undirected degree per node: count both endpoints of each edge."""
    return np.bincount(edge_index.reshape(-1), minlength=num_nodes)


def labels_by_time(y: np.ndarray, timestep: np.ndarray):
    rows = []
    for t in sorted(set(int(v) for v in np.unique(timestep))):
        m = timestep == t
        rows.append({
            "timestep": t,
            "n_nodes": int(m.sum()),
            "n_unknown": int((y[m] == -1).sum()),
            "n_licit": int((y[m] == 0).sum()),
            "n_illicit": int((y[m] == 1).sum()),
        })
    return rows


def find_cross_time_edges(edge_index: np.ndarray, timestep: np.ndarray) -> np.ndarray:
    """Edge ids whose endpoints live in different timesteps."""
    src_t = timestep[edge_index[0]]
    dst_t = timestep[edge_index[1]]
    return np.where(src_t != dst_t)[0]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--processed_dir", type=str, default="data/processed")
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--assert_no_cross_time_edges", action="store_true")
    args = parser.parse_args(argv)

    data = load_processed(args.processed_dir)
    out_dir = args.out_dir or os.path.join("outputs", "eda")
    ensure_dir(out_dir)

    deg = degree_histogram(data.edge_index, data.num_nodes)
    hist_vals, hist_counts = np.unique(deg, return_counts=True)
    with open(os.path.join(out_dir, "degree_hist.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["degree", "n_nodes"])
        for d, c in zip(hist_vals, hist_counts):
            w.writerow([int(d), int(c)])

    rows = labels_by_time(data.y, data.timestep)
    with open(os.path.join(out_dir, "labels_by_time.csv"), "w", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=["timestep", "n_nodes", "n_unknown", "n_licit", "n_illicit"]
        )
        w.writeheader()
        w.writerows(rows)

    print(f"[EDA] nodes={data.num_nodes} edges={data.num_edges} "
          f"max_degree={int(deg.max()) if deg.size else 0}")
    print(f"[EDA] wrote degree_hist.csv and labels_by_time.csv to {out_dir}")

    if args.assert_no_cross_time_edges:
        bad = find_cross_time_edges(data.edge_index, data.timestep)
        if bad.size > 0:
            print(f"[EDA] FAIL: {bad.size} cross-timestep edges found:")
            for e in bad[:20]:
                s, d = data.edge_index[:, e]
                print(f"  edge {e}: {s}(t={data.timestep[s]}) -> "
                      f"{d}(t={data.timestep[d]})")
            sys.exit(1)
        print("[EDA] OK: no cross-timestep edges.")


if __name__ == "__main__":
    main()
