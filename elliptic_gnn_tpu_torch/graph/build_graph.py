"""Graph-build CLI: raw CSVs (or synthetic) -> processed graph.npz + meta.json.

Counterpart of elliptic_gnn_tpu/graph/build_graph.py:
    python -m elliptic_gnn_tpu_torch.graph.build_graph --config configs/split.yaml
The three Elliptic CSVs under `data_dir` are read by graph/ingest.py. If
they are missing (or are git-lfs pointer stubs), or the config sets
`synthetic: true` (or --synthetic is passed), a deterministic Elliptic-like
synthetic graph is built instead so the pipeline stays runnable end to end.
"""
from __future__ import annotations

import argparse
import os

import yaml

from ..utils.common import ensure_dir, save_json, set_seed
from .data import save_processed
from .ingest import load_elliptic_as_graph
from .masks import make_temporal_masks
from . import synthetic


def _raw_csvs_usable(data_dir: str, names) -> bool:
    for name in names:
        p = os.path.join(data_dir, name)
        if not os.path.exists(p):
            return False
        with open(p, "rb") as fh:
            head = fh.read(64)
        if head.startswith(b"version https://git-lfs"):
            return False
    return True


def main(cfg: dict) -> None:
    set_seed(cfg.get("seed", 42))
    data_dir = cfg.get("data_dir", "data/raw")
    names = (
        cfg.get("features_csv", "elliptic_txs_features.csv"),
        cfg.get("classes_csv", "elliptic_txs_classes.csv"),
        cfg.get("edgelist_csv", "elliptic_txs_edgelist.csv"),
    )
    use_synth = bool(cfg.get("synthetic", False)) or not _raw_csvs_usable(data_dir, names)
    if use_synth:
        print("[BUILD] raw CSVs unavailable or synthetic requested -> synthetic graph")
        data = synthetic.generate(
            num_nodes=int(cfg.get("synthetic_nodes", 20000)),
            num_features=int(cfg.get("synthetic_features", 166)),
            num_timesteps=int(cfg.get("t_max", 49)),
            seed=int(cfg.get("seed", 42)),
        )
        meta = data.meta()
        meta["source"] = "synthetic"
    else:
        data, meta = load_elliptic_as_graph(data_dir, *names)
        meta["source"] = "elliptic_csv"

    data = make_temporal_masks(
        data,
        t_train_end=int(cfg.get("t_train_end", 34)),
        t_val_end=int(cfg.get("t_val_end", 43)),
    )
    data.validate()

    processed_dir = cfg.get("processed_dir", "data/processed")
    ensure_dir(processed_dir)
    save_processed(data, processed_dir, extra_meta=meta)
    save_json(os.path.join(processed_dir, "meta.json"), meta)
    print(f"[BUILD] wrote {processed_dir}/graph.npz  ({meta['num_nodes']} nodes, "
          f"{meta['num_edges']} edges, {meta['num_features']} features)")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--synthetic", action="store_true")
    args = parser.parse_args()
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    if args.synthetic:
        cfg["synthetic"] = True
    main(cfg)
