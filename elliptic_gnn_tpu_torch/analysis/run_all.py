"""The post-hoc battery on a run dir in one process (port of
elliptic_gnn_tpu/analysis/run_all.py), stages in order:

  eval_by_time, calibration, workload, robustness, hub_ablation, explain
  (the GNN explainer), report.

robustness, hub_ablation and explain run on the run's device (the GPU
unless its config says `device: cpu`): the first two score the whole graph
through the kernels, the explainer runs the ELL gather on the node's
subgraph. A stage that raises prints its traceback and
"[RUN_ALL] <stage> FAILED (continuing)", and the next stage runs. Where
matplotlib does not import, the stages write their CSV and JSON and say
which figure they did not draw (common.pyplot).

CLI: python -m elliptic_gnn_tpu_torch.analysis.run_all --run_dir outputs/gnn/<run>
         [--drop_frac 0.1] [--noise_std 0.0] [--hub_frac 0.01] [--k_max 5000]
         [--explain_steps 200] [--skip explain,robustness] [--outputs outputs]
"""
from __future__ import annotations

import argparse
import traceback
from pathlib import Path

from . import (calibration_plots, eval_by_time, explain, hub_ablation, report,
               robustness, workload_curves)


def main(argv=None) -> list:
    """Runs the stages; returns the names of those that failed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", type=str, required=True)
    ap.add_argument("--drop_frac", type=float, default=0.1)
    ap.add_argument("--noise_std", type=float, default=0.0)
    ap.add_argument("--hub_frac", type=float, default=0.01)
    ap.add_argument("--k_max", type=int, default=5000)
    ap.add_argument("--explain_steps", type=int, default=200)
    ap.add_argument("--skip", type=str, default="",
                    help="comma-separated stage names to skip")
    ap.add_argument("--outputs", type=str, default="outputs")
    args = ap.parse_args(argv)
    skip = {s.strip() for s in args.skip.split(",") if s.strip()}
    failed = []

    def stage(name, fn):
        if name in skip:
            print(f"[RUN_ALL] skip {name}")
            return
        print(f"[RUN_ALL] {name} ...")
        try:
            fn()
        except Exception:
            traceback.print_exc()
            print(f"[RUN_ALL] {name} FAILED (continuing)")
            failed.append(name)

    run_dir = args.run_dir
    stage("eval_by_time", lambda: eval_by_time.main(run_dir))
    stage("calibration", lambda: calibration_plots.main(run_dir))
    stage("workload", lambda: workload_curves.main(run_dir, args.k_max))
    stage("robustness", lambda: robustness.main([
        "--run_dir", run_dir, "--drop_frac", str(args.drop_frac),
        "--noise_std", str(args.noise_std)]))
    stage("hub_ablation", lambda: hub_ablation.main([
        "--run_dir", run_dir, "--frac", str(args.hub_frac)]))
    stage("explain", lambda: explain.run_gnn(run_dir, steps=args.explain_steps))
    stage("report", lambda: report.render(
        Path(args.outputs), Path(args.outputs) / "report.html"))
    print("[RUN_ALL] done")
    return failed


if __name__ == "__main__":
    main()
