"""Batch scoring (serving) CLI: load a trained run, score a processed graph
(port of elliptic_gnn_tpu/train/predict.py).

Scores every node of a processed graph with a trained model: config_used.yaml
-> rebuild -> best.ckpt -> forward, with the run's stored temperature, and
flags at the trained threshold. Runs on the run's device (the GPU unless
its config says `device: cpu`); `--device` overrides it.

CLI: python -m elliptic_gnn_tpu_torch.train.predict --run_dir outputs/gnn/<run>
         [--processed_dir data/processed] [--out scores.csv]
         [--format csv|npy] [--splits all|test|val] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from ..analysis.common import load_run_metrics, model_probs, rebuild_model_and_data


def predict(run_dir: str, processed_dir: Optional[str] = None,
            device: Optional[str] = None):
    """Returns (node_idx [N], probs [N], flags [N], threshold, data), the
    first three in on-disk node order."""
    metrics = load_run_metrics(run_dir)
    thr = float(metrics.get("threshold", 0.5))
    temp = float(metrics.get("temperature", 1.0))

    _, data, gops, model = rebuild_model_and_data(
        run_dir, processed_dir=processed_dir, device=device)
    probs = model_probs(data, gops, model, temperature=temp)
    orig = (
        data.orig_index
        if data.orig_index is not None
        else np.arange(data.num_nodes)
    )
    order = np.argsort(orig)
    return orig[order], probs[order], (probs[order] >= thr), thr, data


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", type=str, required=True)
    ap.add_argument("--processed_dir", type=str, default=None)
    ap.add_argument("--out", type=str, default=None,
                    help="default: <run_dir>/predictions.csv")
    ap.add_argument("--format", type=str, default="csv", choices=["csv", "npy"])
    ap.add_argument("--splits", type=str, default="all",
                    choices=["all", "test", "val"])
    ap.add_argument("--device", type=str, default=None, choices=["cpu", "cuda"])
    args = ap.parse_args()

    node_idx, probs, flags, thr, data = predict(
        args.run_dir, args.processed_dir, args.device)

    mask = np.ones(node_idx.size, dtype=bool)
    if args.splits != "all":
        split_mask = data.test_mask if args.splits == "test" else data.val_mask
        orig = (
            data.orig_index
            if data.orig_index is not None
            else np.arange(data.num_nodes)
        )
        mask = np.isin(node_idx, orig[split_mask])

    out = args.out or os.path.join(
        args.run_dir,
        "predictions.csv" if args.format == "csv" else "predictions.npy",
    )
    if args.format == "npy":
        np.save(out, np.stack([node_idx[mask], probs[mask]], axis=1))
    else:
        with open(out, "w") as f:
            f.write("node_idx,score_illicit,flagged\n")
            for n, p, fl in zip(node_idx[mask], probs[mask], flags[mask]):
                f.write(f"{int(n)},{p:.6f},{int(fl)}\n")
    print(f"[PREDICT] scored {int(mask.sum())} nodes "
          f"(threshold={thr:.4f}, flagged={int(flags[mask].sum())}); wrote {out}")


if __name__ == "__main__":
    main()
