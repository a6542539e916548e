"""Standalone hub ablation (port of elliptic_gnn_tpu/analysis/hub_ablation.py):
drop all edges touching the top-degree nodes, score the trained model
again through the kernels, write metrics_hub_removed_<frac>.json.

Degree = in + out over the prepared edge set, in on-disk numbering as the
JAX tool counts it; the run's threshold and temperature are reused, and the
time embedding is passed as the trainer's inline ablation passes it. Runs
on the run's device (the GPU unless its config says `device: cpu`);
`--device` overrides it.

CLI: python -m elliptic_gnn_tpu_torch.analysis.hub_ablation --run_dir <dir>
         [--frac 0.01] [--processed_dir <dir>] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import os

from ..graph.transform import remove_hub_edges
from ..train.train_gnn import test_metrics_at_threshold
from ..utils.common import save_json
from .common import load_run_data, load_run_metrics, model_probs, rebuild_on


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_dir", type=str, required=True)
    parser.add_argument("--frac", type=float, default=0.01)
    parser.add_argument("--processed_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None, choices=["cpu", "cuda"])
    args = parser.parse_args(argv)

    run_metrics = load_run_metrics(args.run_dir)
    thr = float(run_metrics["threshold"])
    temp = float(run_metrics.get("temperature", 1.0))

    cfg, data = load_run_data(args.run_dir, args.processed_dir)
    n_edges = data.num_edges
    ei_abl, num_hubs = remove_hub_edges(data.edge_index, data.num_nodes, args.frac)
    data, gops, model = rebuild_on(cfg, data.replace(edge_index=ei_abl),
                                   args.run_dir, args.device)
    probs = model_probs(data, gops, model, temperature=temp)

    y_te = data.y[data.test_mask]
    out = test_metrics_at_threshold(cfg, (y_te == 1).astype(int),
                                    probs[data.test_mask], thr)
    out.update(n_hubs=int(num_hubs), hub_fraction=float(args.frac),
               n_edges_remaining=int(ei_abl.shape[1]))
    frac_str = str(args.frac).replace(".", "p")
    path = os.path.join(args.run_dir, f"metrics_hub_removed_{frac_str}.json")
    save_json(path, out)
    print(f"[HUB] frac={args.frac} hubs={num_hubs} "
          f"edges {n_edges} -> {ei_abl.shape[1]}; wrote {path}")
    print({k: round(v, 4) if isinstance(v, float) else v for k, v in out.items()})
    return out


if __name__ == "__main__":
    main()
