"""Parameter sweep over a template config (port of
elliptic_gnn_tpu/analysis/sweep.py):
  - `--param name v1 v2 ...` grids over any (possibly dotted) config key;
  - each combo runs `python -m elliptic_gnn_tpu_torch.train.train_gnn` as
    a subprocess, with failure capture (`run_status=failed` rows instead
    of aborting the sweep);
  - all resulting metrics.json rows merge into a single CSV.
The trainers run on the template's device (`device: cpu` for the CPU).

CLI: python -m elliptic_gnn_tpu_torch.analysis.sweep --template configs/rec_k8.yaml
         --param lr 0.0005 0.001 --param hidden_dim 32 64
         [--out outputs/sweeps/param_sweep.csv] [--jobs 1]
"""
from __future__ import annotations

import argparse
import csv
import itertools
import json
import os
import subprocess
import sys
import tempfile

import yaml

from ..utils.common import ensure_dir


def set_dotted(cfg: dict, key: str, value) -> None:
    parts = key.split(".")
    cur = cfg
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def parse_value(s: str):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--template", type=str, required=True)
    ap.add_argument("--param", nargs="+", action="append", required=True,
                    help="name v1 v2 ... (repeatable)")
    ap.add_argument("--out", type=str, default="outputs/sweeps/param_sweep.csv")
    ap.add_argument("--output_root", type=str, default="outputs")
    ap.add_argument("--jobs", type=int, default=1,
                    help="concurrent training subprocesses (sweep-level "
                         "task parallelism; keep 1 per accelerator)")
    args = ap.parse_args(argv)

    with open(args.template) as f:
        base = yaml.safe_load(f)

    names = [p[0] for p in args.param]
    values = [[parse_value(v) for v in p[1:]] for p in args.param]
    combos = list(itertools.product(*values))
    print(f"[SWEEP] {len(combos)} combos over {names}")

    def run_one(i_combo):
        i, combo = i_combo
        cfg = yaml.safe_load(yaml.safe_dump(base))  # deep copy
        tag_parts = []
        for name, val in zip(names, combo):
            set_dotted(cfg, name, val)
            tag_parts.append(f"{name.split('.')[-1]}{val}")
        run_name = f"{base.get('run_name', 'sweep')}_" + "_".join(tag_parts)
        run_name = run_name.replace(".", "p").replace("-", "m")
        cfg["run_name"] = run_name
        cfg["output_root"] = args.output_root

        with tempfile.NamedTemporaryFile(
            "w", suffix=".yaml", delete=False
        ) as tf:
            yaml.safe_dump(cfg, tf)
            cfg_path = tf.name

        print(f"[{i}/{len(combos)}] {run_name}")
        proc = subprocess.run(
            [sys.executable, "-m", "elliptic_gnn_tpu_torch.train.train_gnn",
             "--config", cfg_path],
            capture_output=True, text=True,
        )
        os.unlink(cfg_path)

        row = {"run_name": run_name}
        for name, val in zip(names, combo):
            row[name] = val
        mpath = os.path.join(args.output_root, "gnn", run_name, "metrics.json")
        if proc.returncode == 0 and os.path.exists(mpath):
            with open(mpath) as f:
                m = json.load(f)
            row.update({
                k: v for k, v in m.items() if not isinstance(v, (list, dict))
            })
            row["run_status"] = "ok"
        else:
            row["run_status"] = "failed"
            print(proc.stderr[-500:] if proc.stderr else "(no stderr)")
        return row

    items = list(enumerate(combos, 1))
    if args.jobs > 1:
        # sweep-level task parallelism: one trainer process per combo
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=args.jobs) as pool:
            rows = list(pool.map(run_one, items))
    else:
        rows = [run_one(it) for it in items]

    ensure_dir(os.path.dirname(args.out) or ".")
    cols = sorted({k for r in rows for k in r})
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    print(f"[SWEEP] wrote {args.out}")


if __name__ == "__main__":
    main()
