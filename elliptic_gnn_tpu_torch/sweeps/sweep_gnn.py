"""In-process hyperparameter grid sweep with leaderboard and resume (port
of elliptic_gnn_tpu/sweeps/sweep_gnn.py):
  - cartesian grid over config keys; combo normalization (time_embed_dim=0
    disables embeds; sin embeds require dim in {2,4}) + de-dup;
  - deterministic run names from an abbreviation table;
  - resume by skipping any combo whose metrics.json already exists;
  - trains each combo through the port's train_gnn.main, catching per-run
    exceptions; `--workers N` trains N combos at once in a process pool
    (sweeps/_worker.py);
  - writes <output_root>/sweeps/last_sweep.{txt,tsv,jsonl}, a per-timestep
    TSV, leaderboard.tsv ranked by --rank_key (e.g. pr_auc_last3), and
    points <output_root>/gnn/best at the winner (symlink; POINTER.txt +
    copies where symlinks fail);
  - symmetrize_edges is forced on for every combo.
Combos run on the base config's device (`device: cpu` for the CPU); the
workers too, all on one card unless `--worker_env CUDA_VISIBLE_DEVICES={slot}`
gives each its own.

CLI: python -m elliptic_gnn_tpu_torch.sweeps.sweep_gnn --base configs/rec_k8.yaml
         [--rank_key pr_auc_last3] [--grid grids/my_grid.yaml] [--workers 2]
"""
from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import shutil
import time
from datetime import datetime
from typing import Dict, List

import torch
import yaml

from ..train.train_gnn import main as train_main
from ..utils.common import ensure_dir, load_json

ABBREV = {
    "hidden_dim": "hid",
    "layers": "lay",
    "dropout": "dro",
    "lr": "lr",
    "weight_decay": "wei",
    "train_window_k": "tra",
    "time_embed_dim": "tim",
    "time_embed_type": "tmt",
    "time_embed_l2": "tel2",
    "time_loss_weighting": "tlw",
    "patience": "pat",
}

DEFAULT_GRID = dict(
    hidden_dim=[64],
    layers=[3],
    dropout=[0.2, 0.25],
    lr=[5e-4, 7e-4],
    weight_decay=[5e-5, 1e-4],
    train_window_k=[8, 9, 10],
    time_embed_dim=[0, 2, 4],
    time_embed_type=["sin", "none"],
    time_embed_l2=[0.0, 1e-4],
    time_loss_weighting=["none", "sqrt", "linear"],
    symmetrize_edges=[True],
    patience=[30],
)

CFG_ECHO_KEYS = [
    "arch", "hidden_dim", "layers", "dropout", "lr", "weight_decay",
    "train_window_k", "time_embed_dim", "time_embed_type", "time_embed_l2",
    "time_loss_weighting", "patience",
]


def slug(v) -> str:
    if isinstance(v, bool):
        return "t" if v else "f"
    if isinstance(v, float):
        return f"{v:.10g}".replace(".", "p").replace("-", "m")
    return str(v)


def normalize_combos(combos: List[dict]) -> List[dict]:
    """Drop invalid combos, canonicalize disabled time embeds, de-dup."""
    sane = []
    for c in combos:
        c = dict(c)
        if c.get("time_embed_dim", 0) == 0:
            c["time_embed_type"] = "none"
            c["time_embed_l2"] = 0.0
        if c.get("time_embed_type") == "sin" and c.get("time_embed_dim") not in (2, 4):
            continue
        sane.append(c)
    seen, unique = set(), []
    for c in sane:
        key = json.dumps(c, sort_keys=True)
        if key not in seen:
            seen.add(key)
            unique.append(c)
    return unique


def make_run_name(cfg: dict) -> str:
    rn = cfg.get("arch", "model")
    if "sage" in rn:
        rn = "sage_resbn"
    for k, tag in ABBREV.items():
        if k in cfg:
            rn += f"_{tag}{slug(cfg[k])}"
    return rn


def read_metrics(run_name: str, output_root: str = "outputs") -> Dict:
    outdir = os.path.join(output_root, "gnn", run_name)
    rec = {"run_name": run_name, "outdir": outdir}
    mpath = os.path.join(outdir, "metrics.json")
    if os.path.exists(mpath):
        try:
            rec.update(load_json(mpath))
        except Exception:
            pass
    cpath = os.path.join(outdir, "config_used.yaml")
    if os.path.exists(cpath):
        with open(cpath) as f:
            cfg_used = yaml.safe_load(f) or {}
        for k in CFG_ECHO_KEYS:
            if k in cfg_used:
                rec[f"cfg_{k}"] = cfg_used[k]
    return rec


def point_best_to(outdir: str, output_root: str = "outputs") -> str:
    """Point outputs/gnn/best at the winning run dir; symlink when the
    filesystem allows, POINTER.txt + metric copies otherwise."""
    tgt = os.path.abspath(outdir)
    best_dir = os.path.join(output_root, "gnn", "best")
    if os.path.islink(best_dir):
        os.unlink(best_dir)
    elif os.path.exists(best_dir):
        shutil.rmtree(best_dir)
    try:
        os.symlink(tgt, best_dir, target_is_directory=True)
        return "symlink"
    except OSError:
        ensure_dir(best_dir)
        with open(os.path.join(best_dir, "POINTER.txt"), "w") as f:
            f.write(f"Best run:\n{tgt}\nGenerated: {datetime.now().isoformat()}\n")
        for fn in ("metrics.json", "config_used.yaml"):
            src = os.path.join(tgt, fn)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(best_dir, fn))
        return "pointer"


def run_sweep(base_cfg: dict, grid: dict, rank_key: str = "pr_auc_illicit",
              output_root: str = "outputs", workers: int = 1,
              worker_env: dict | None = None) -> List[dict]:
    """Run the grid; with workers > 1, combos train concurrently in a
    process pool. Row order, skip-resume and every output file stay those
    of the sequential path; only wall-clock columns differ. `worker_env`
    sets environment variables in each worker ({slot} = its 0-based
    index), e.g. CUDA_VISIBLE_DEVICES={slot} for one card per worker."""
    keys = list(grid.keys())
    combos = [dict(zip(keys, vals)) for vals in itertools.product(*grid.values())]
    combos = normalize_combos(combos)
    print(f"[SWEEP] {len(combos)} unique combinations after normalization"
          + (f" ({workers} workers)" if workers > 1 else ""))

    rows: List[dict | None] = [None] * len(combos)
    pending = []  # (row index, cfg, run_name) for combos not skip-resumed
    for i, combo in enumerate(combos):
        cfg = copy.deepcopy(base_cfg)
        cfg["symmetrize_edges"] = True
        cfg.update(combo)
        cfg["output_root"] = output_root
        rn = make_run_name(cfg)
        cfg["run_name"] = rn

        outdir = os.path.join(output_root, "gnn", rn)
        if os.path.exists(os.path.join(outdir, "metrics.json")):
            print(f"[SKIP] {rn} already has metrics.json")
            rec = read_metrics(rn, output_root)
            rec["dt_seconds"] = 0.0
            rows[i] = rec
            continue
        pending.append((i, cfg, rn))

    if workers <= 1:
        for n, (i, cfg, rn) in enumerate(pending, 1):
            print(f"\n[{n}/{len(pending)}] run_name={rn}")
            t0 = time.time()
            try:
                train_main(cfg)
            except Exception as e:  # keep sweeping past failed combos
                print(f"[ERROR] {rn}: {e}")
            rec = read_metrics(rn, output_root)
            rec["dt_seconds"] = round(time.time() - t0, 2)
            rows[i] = rec
    elif pending:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, as_completed

        from . import _worker

        # spawn, never fork: each worker makes its own CUDA context, after
        # init_worker has set its environment
        _build_kernels([cfg for _, cfg, _ in pending])
        ctx = multiprocessing.get_context("spawn")
        done = 0
        with ProcessPoolExecutor(
            max_workers=workers, mp_context=ctx,
            initializer=_worker.init_worker, initargs=(dict(worker_env or {}),),
        ) as pool:
            futs = {pool.submit(_worker.run_one, cfg): (i, rn)
                    for i, cfg, rn in pending}
            for fut in as_completed(futs):
                i, rn = futs[fut]
                err, dt = fut.result()
                done += 1
                if err:
                    print(f"[ERROR] {rn}: {err}")
                print(f"[{done}/{len(pending)}] done run_name={rn} dt={dt}s")
                rec = read_metrics(rn, output_root)
                rec["dt_seconds"] = dt
                rows[i] = rec

    rows = [r for r in rows if r is not None]
    per_timestep_map = {
        r["run_name"]: r["test_pr_auc_by_time"]
        for r in rows if r.get("test_pr_auc_by_time")
    }
    sweep_dir = ensure_dir(os.path.join(output_root, "sweeps"))
    _write_outputs(rows, per_timestep_map, sweep_dir, rank_key, output_root)
    return rows


def _build_kernels(cfgs: List[dict]) -> None:
    """Build the CUDA kernels' libraries once, before the pool starts, where
    a combo runs on the card: the workers then load the same files and none
    compiles (without a card the workers' runs fail on their own)."""
    if torch.cuda.is_available() and any(
            str(c.get("device", "auto")) != "cpu" for c in cfgs):
        from ..kernels import cuda_build

        cuda_build.build(list(cuda_build.SOURCES))


def _write_outputs(rows, per_timestep_map, sweep_dir, rank_key, output_root):
    cols = sorted({k for r in rows for k in r if not isinstance(r[k], (list, dict))})
    with open(os.path.join(sweep_dir, "last_sweep.tsv"), "w") as f:
        f.write("\t".join(cols) + "\n")
        for r in rows:
            f.write("\t".join(str(r.get(c, "")) for c in cols) + "\n")
    with open(os.path.join(sweep_dir, "last_sweep.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    with open(os.path.join(sweep_dir, "last_sweep.txt"), "w") as f:
        for r in rows:
            f.write(
                f"{r['run_name']}  {rank_key}={r.get(rank_key, float('nan'))} "
                f"dt={r.get('dt_seconds', 0)}s\n"
            )
    with open(os.path.join(sweep_dir, "last_sweep_per_timestep.tsv"), "w") as f:
        f.write("run_name\t" + "\t".join(
            f"t{i}" for i in range(max((len(v) for v in per_timestep_map.values()), default=0))
        ) + "\n")
        for rn, vals in per_timestep_map.items():
            f.write(rn + "\t" + "\t".join(f"{v:.4f}" for v in vals) + "\n")

    ranked = sorted(
        [r for r in rows if isinstance(r.get(rank_key), (int, float))],
        key=lambda r: -r[rank_key],
    )
    with open(os.path.join(sweep_dir, "leaderboard.tsv"), "w") as f:
        f.write(f"rank\trun_name\t{rank_key}\tpr_auc_illicit\tdt_seconds\n")
        for i, r in enumerate(ranked, 1):
            f.write(
                f"{i}\t{r['run_name']}\t{r.get(rank_key, '')}\t"
                f"{r.get('pr_auc_illicit', '')}\t{r.get('dt_seconds', '')}\n"
            )
    if ranked:
        best = ranked[0]
        mode = point_best_to(best["outdir"], output_root)
        print(f"\n[BEST] {best['run_name']} {rank_key}={best[rank_key]:.4f} "
              f"({mode} -> outputs/gnn/best)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=str, required=True)
    ap.add_argument("--rank_key", type=str, default="pr_auc_illicit",
                    help="metric to rank by (e.g. pr_auc_last3)")
    ap.add_argument("--grid", type=str, default=None,
                    help="yaml file mapping config keys to value lists")
    ap.add_argument("--workers", type=int, default=1,
                    help="combos trained concurrently (process pool); the "
                         "workers run on the base config's device, all on "
                         "one card unless --worker_env pins them")
    ap.add_argument("--output_root", type=str, default="outputs")
    ap.add_argument("--worker_env", action="append", default=[],
                    metavar="KEY=VAL",
                    help="env var for each worker; {slot} expands to the "
                         "0-based worker index, e.g. "
                         "CUDA_VISIBLE_DEVICES={slot} for one card per worker")
    args = ap.parse_args()

    with open(args.base) as f:
        base_cfg = yaml.safe_load(f)
    if args.grid:
        with open(args.grid) as f:
            grid = yaml.safe_load(f)
    else:
        grid = DEFAULT_GRID
    wenv = dict(kv.split("=", 1) for kv in args.worker_env)
    run_sweep(base_cfg, grid, rank_key=args.rank_key, workers=args.workers,
              worker_env=wenv, output_root=args.output_root)
