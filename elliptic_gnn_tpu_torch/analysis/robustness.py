"""Robustness evaluation (port of elliptic_gnn_tpu/analysis/robustness.py):
random edge drops and Gaussian feature noise, then the trained model scored
again through the kernels at the originally trained threshold.

  - drop `drop_frac` of the prepared (post-symmetrize) edges uniformly, in
    on-disk numbering with the JAX tool's seeded choice;
  - add N(0, noise_std^2) to the features, drawn as the JAX tool draws it;
  - fit the temperature again on the perturbed val logits;
  - metrics at the threshold of metrics.json;
  - write robustness_drop<frac>_noise<std>.json into the run dir.

CLI: python -m elliptic_gnn_tpu_torch.analysis.robustness --run_dir <dir>
         [--drop_frac 0.1] [--noise_std 0.0] [--seed 42]
         [--processed_dir <dir>] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..graph.transform import drop_edges
from ..train import calibrate
from ..train.train_gnn import test_metrics_at_threshold
from ..utils.common import save_json
from .common import load_run_data, load_run_metrics, model_logits, rebuild_on


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_dir", type=str, required=True)
    parser.add_argument("--drop_frac", type=float, default=0.1)
    parser.add_argument("--noise_std", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--processed_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None, choices=["cpu", "cuda"])
    args = parser.parse_args(argv)

    run_metrics = load_run_metrics(args.run_dir)
    if "threshold" not in run_metrics:
        raise KeyError("metrics.json does not contain 'threshold'")
    thr = float(run_metrics["threshold"])

    cfg, data = load_run_data(args.run_dir, args.processed_dir)
    n_edges = data.num_edges
    ei = drop_edges(data.edge_index, args.drop_frac, seed=args.seed)
    data = data.replace(edge_index=ei)
    if args.noise_std > 0:
        rng = np.random.default_rng(args.seed)
        data = data.replace(
            x=data.x + rng.normal(0, args.noise_std, data.x.shape).astype(np.float32))
    data, gops, model = rebuild_on(cfg, data, args.run_dir, args.device)
    logits = model_logits(data, gops, model)

    temp = 1.0
    if bool(cfg.get("calibrate_temperature", True)):
        y_val_bin = (data.y[data.val_mask] == 1).astype(int)
        temp = calibrate.fit_temperature(logits[data.val_mask], y_val_bin)
    probs = calibrate.calibrated_probs(logits, temp)

    y_te = data.y[data.test_mask]
    metrics = test_metrics_at_threshold(cfg, (y_te == 1).astype(int),
                                        probs[data.test_mask], thr)
    out = dict(drop_frac=float(args.drop_frac), noise_std=float(args.noise_std),
               n_edges_original=int(n_edges), n_edges_remaining=int(ei.shape[1]),
               temperature=float(temp), **metrics)
    name = f"robustness_drop{args.drop_frac}_noise{args.noise_std}.json"
    path = os.path.join(args.run_dir, name)
    save_json(path, out)
    print(f"[ROBUST] wrote {path}")
    print({k: round(v, 4) if isinstance(v, float) else v for k, v in out.items()})
    return out


if __name__ == "__main__":
    main()
