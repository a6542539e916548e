"""The grid sweep (sweeps/sweep_gnn.py, sweeps/_worker.py) against the JAX
package's, on the CPU:

  - the same abbreviations, default grid, slugs, normalized combos and run
    names as the JAX sweep;
  - a two-combo sweep through the port's trainer, sequential and with two
    spawned workers: the same leaderboard with the time column dropped, the
    best pointer, and a second call that skips every combo;
  - the POINTER.txt fallback where symlinks fail.
"""
import copy
import itertools
import os

import numpy as np
import pytest

from elliptic_gnn_tpu.sweeps import sweep_gnn as jax_sweep
from elliptic_gnn_tpu_torch.graph import build_graph
from elliptic_gnn_tpu_torch.sweeps import sweep_gnn


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    cfg = {"seed": 0, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
           "synthetic": True, "synthetic_nodes": 1200,
           "processed_dir": str(root / "processed")}
    build_graph.main(cfg)
    return cfg["processed_dir"]


def _base(processed_dir):
    return {"seed": 3, "processed_dir": processed_dir, "device": "cpu",
            "arch": "sage", "hidden_dim": 16, "layers": 2, "dropout": 0.0,
            "lr": 0.01, "weight_decay": 1e-4, "max_epochs": 3, "patience": 3,
            "topk": 20, "calibrate_temperature": False}


def _leaderboard_sans_time(root):
    with open(os.path.join(root, "sweeps", "leaderboard.tsv")) as f:
        return [line.rsplit("\t", 1)[0] for line in f.read().splitlines()]


def test_names_and_combos_match_jax():
    assert sweep_gnn.ABBREV == jax_sweep.ABBREV
    assert sweep_gnn.DEFAULT_GRID == jax_sweep.DEFAULT_GRID
    for v in (True, False, 5e-4, -1e-4, 0.25, 64, "sin"):
        assert sweep_gnn.slug(v) == jax_sweep.slug(v)
    grid = sweep_gnn.DEFAULT_GRID
    combos = [dict(zip(grid, vals)) for vals in itertools.product(*grid.values())]
    got = sweep_gnn.normalize_combos(copy.deepcopy(combos))
    want = jax_sweep.normalize_combos(copy.deepcopy(combos))
    assert got == want and len(got) < len(combos)
    for arch in ("sage_resbn", "gat", "gcn"):
        for c in got[:50]:
            cfg = dict(c, arch=arch)
            assert sweep_gnn.make_run_name(cfg) == jax_sweep.make_run_name(cfg)


def test_sweep_sequential_and_workers(processed, tmp_path):
    base = _base(processed)
    grid = {"hidden_dim": [16, 24], "lr": [0.01]}
    seq_root, par_root = str(tmp_path / "out_seq"), str(tmp_path / "out_par")
    rows = sweep_gnn.run_sweep(base, grid, rank_key="pr_auc_illicit",
                               output_root=seq_root)
    combos = jax_sweep.normalize_combos([{"hidden_dim": h, "lr": 0.01} for h in (16, 24)])
    assert [r["run_name"] for r in rows] == [
        jax_sweep.make_run_name(dict(base, **c)) for c in combos]
    par = sweep_gnn.run_sweep(base, grid, rank_key="pr_auc_illicit",
                              output_root=par_root, workers=2)
    assert all(isinstance(r.get("pr_auc_illicit"), float) for r in rows + par)
    assert _leaderboard_sans_time(par_root) == _leaderboard_sans_time(seq_root)
    for a, b in zip(rows, par):
        np.testing.assert_array_equal(
            np.load(os.path.join(a["outdir"], "scores_test.npy")),
            np.load(os.path.join(b["outdir"], "scores_test.npy")))
    for root in (seq_root, par_root):
        for name in ("last_sweep.txt", "last_sweep.tsv", "last_sweep.jsonl",
                     "last_sweep_per_timestep.tsv"):
            assert os.path.exists(os.path.join(root, "sweeps", name))
        best = os.path.join(root, "gnn", "best")
        assert os.path.islink(best)
        winner = _leaderboard_sans_time(root)[1].split("\t")[1]
        assert os.path.realpath(best) == os.path.realpath(
            os.path.join(root, "gnn", winner))
    # resume: a second call skips every combo, in either mode
    again = sweep_gnn.run_sweep(base, grid, rank_key="pr_auc_illicit",
                                output_root=par_root, workers=2)
    assert all(r["dt_seconds"] == 0.0 for r in again)
    assert _leaderboard_sans_time(par_root) == _leaderboard_sans_time(seq_root)


def test_point_best_pointer_fallback(tmp_path, monkeypatch):
    run = tmp_path / "gnn" / "run_a"
    run.mkdir(parents=True)
    (run / "metrics.json").write_text("{}")

    def no_symlink(*args, **kwargs):
        raise OSError("symlinks not supported")

    monkeypatch.setattr(os, "symlink", no_symlink)
    assert sweep_gnn.point_best_to(str(run), str(tmp_path)) == "pointer"
    best = tmp_path / "gnn" / "best"
    assert str(run) in (best / "POINTER.txt").read_text()
    assert (best / "metrics.json").read_text() == "{}"
