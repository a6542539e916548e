"""Port parity of the run-dir analysis CLIs: each package's tool on its own
copy of one port run dir (trained by the port on the CPU, 3 epochs; the
JAX tools read it, best.ckpt being the JAX npz layout), files compared.

  - run_all, every stage: by_time.csv and workload_curve.csv equal byte
    for byte (both from the same scores_test.npy); the robustness and
    hub-ablation JSON as test_torch_port_resume_hubs.py holds them
    (metrics atol 2e-3, the refitted temperature rtol 2e-3, counts
    exactly); the explainer's node, pick and class equal; every PNG and
    report.html present and not empty; no stage failed;
  - bootstrap_compare, evaluate_ensemble (mode logit and prob), eda and
    report: equal outputs (the same numpy on the same inputs), the
    ensemble's metrics.json apart from the run paths it echoes;
  - sweep: a two-combo sweep of a `device: cpu` template through each
    package's trainer subprocesses (two at a time): the same rows, parameters and statuses,
    the same columns (the port's metrics.json adds epochs_per_sync), and
    equal n_test and epochs_run (the trainers start from their own random
    inits, so their metrics differ)."""
import csv
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from elliptic_gnn_tpu.analysis import bootstrap_compare as jax_bootstrap
from elliptic_gnn_tpu.analysis import eda as jax_eda
from elliptic_gnn_tpu.analysis import evaluate_ensemble as jax_ensemble
from elliptic_gnn_tpu.analysis import report as jax_report
from elliptic_gnn_tpu.analysis import run_all as jax_run_all
from elliptic_gnn_tpu.analysis import sweep as jax_sweep
from elliptic_gnn_tpu_torch.analysis import (bootstrap_compare, eda, evaluate_ensemble,
                                             report, run_all, sweep)
from elliptic_gnn_tpu_torch.graph import build_graph
from elliptic_gnn_tpu_torch.train import train_gnn
from tests.port_native_pin import same_native
from tests.test_torch_port_resume_hubs import _close_json
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"seed": 3, "device": "cpu", "arch": "sage", "hidden_dim": 16, "layers": 2,
        "dropout": 0.0, "lr": 0.02, "weight_decay": 1e-4, "max_epochs": 3,
        "patience": 3, "topk": 20, "calibrate_temperature": True}


@pytest.fixture(autouse=True, scope="module")
def _same_native():
    same_native()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("clis")
    processed = str(root / "processed")
    build_graph.main({"seed": 3, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
                      "synthetic": True, "synthetic_nodes": 2500,
                      "processed_dir": processed, "data_dir": str(root / "raw")})
    out_root = str(root / "outputs")
    base = dict(BASE, processed_dir=processed, output_root=out_root)
    train_gnn.main(dict(base, run_name="runA"))
    train_gnn.main(dict(base, run_name="runB", seed=4, hidden_dim=12))
    return {"processed": processed, "base": base,
            "runA": os.path.join(out_root, "gnn", "runA"),
            "runB": os.path.join(out_root, "gnn", "runB")}


def _copies(env, tmp_path, *runs):
    """{package: outputs root} with a copy of each run under <root>/gnn."""
    roots = {}
    for pkg in ("jax", "port"):
        roots[pkg] = tmp_path / pkg
        for r in runs:
            shutil.copytree(env[r], roots[pkg] / "gnn" / r)
    return roots


def _jax_cli(monkeypatch, main, argv):
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    main()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_run_all_matches_jax(env, tmp_path, monkeypatch, capsys):
    roots = _copies(env, tmp_path, "runA")
    args = {pkg: ["--run_dir", str(roots[pkg] / "gnn" / "runA"), "--outputs",
                  str(roots[pkg]), "--explain_steps", "20"] for pkg in roots}
    _jax_cli(monkeypatch, jax_run_all.main, args["jax"])
    capsys.readouterr()
    assert run_all.main(args["port"]) == []
    out = capsys.readouterr().out
    assert "FAILED" not in out and "[RUN_ALL] done" in out
    d = {pkg: roots[pkg] / "gnn" / "runA" for pkg in roots}
    for name in ("by_time.csv", "workload_curve.csv"):
        assert _read(d["port"] / name) == _read(d["jax"] / name), name
    for name in ("robustness_drop0.1_noise0.0.json", "metrics_hub_removed_0p01.json"):
        got, want = (json.loads(_read(d[k] / name)) for k in ("port", "jax"))
        _close_json(got, want)
    got, want = (json.loads(_read(d[k] / "gnn_explainer_importance.json"))
                 for k in ("port", "jax"))
    for k in ("node_idx", "picked", "predicted_class"):
        assert got[k] == want[k], k
    for name in ("by_time_pr_auc.png", "calibration_curve.png", "workload_curve.png",
                 f"gnn_explainer_node_{got['node_idx']}.png"):
        assert os.path.getsize(d["port"] / name) > 0, name
    html = _read(roots["port"] / "report.html").decode()
    assert "1 runs discovered" in html and "data:image/png;base64" in html


def test_run_all_skip_and_failed_stage(env, tmp_path, capsys):
    """--skip skips; a stage that raises is reported and the rest run."""
    roots = _copies(env, tmp_path, "runA")
    run_dir = roots["port"] / "gnn" / "runA"
    os.remove(run_dir / "best.ckpt")
    failed = run_all.main(["--run_dir", str(run_dir), "--outputs", str(roots["port"]),
                           "--skip", "explain,calibration"])
    out = capsys.readouterr().out
    assert failed == ["robustness", "hub_ablation"]
    assert "[RUN_ALL] skip explain" in out and "[RUN_ALL] robustness FAILED (continuing)" in out
    assert (run_dir / "by_time.csv").exists() and (roots["port"] / "report.html").exists()
    assert not (run_dir / "calibration_curve.png").exists()


def test_run_all_without_matplotlib(env, tmp_path, monkeypatch, capsys):
    """Where matplotlib does not import, every stage still runs: the CSV
    and JSON artifacts are written, the figures are not."""
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    roots = _copies(env, tmp_path, "runA")
    run_dir = roots["port"] / "gnn" / "runA"
    assert run_all.main(["--run_dir", str(run_dir), "--outputs", str(roots["port"]),
                         "--explain_steps", "5"]) == []
    out = capsys.readouterr().out
    assert "FAILED" not in out and out.count("matplotlib is not importable") == 4
    for name in ("by_time.csv", "workload_curve.csv", "robustness_drop0.1_noise0.0.json",
                 "metrics_hub_removed_0p01.json", "gnn_explainer_importance.json"):
        assert (run_dir / name).exists(), name
    assert (roots["port"] / "report.html").exists()
    assert not list(run_dir.glob("*.png"))


def test_report_matches_jax(env, tmp_path):
    roots = _copies(env, tmp_path, "runA", "runB")
    jax_report.render(roots["jax"], roots["jax"] / "report.html")
    report.render(roots["jax"], roots["port"] / "report.html")
    assert _read(roots["port"] / "report.html") == _read(roots["jax"] / "report.html")
    report.main(["--outputs", str(roots["port"])])
    assert "2 runs discovered" in _read(roots["port"] / "report.html").decode()


def test_bootstrap_compare_matches_jax(env, tmp_path, monkeypatch):
    roots = _copies(env, tmp_path, "runA", "runB")
    argv = {pkg: ["--run_a", str(roots[pkg] / "gnn" / "runA"), "--run_b",
                  str(roots[pkg] / "gnn" / "runB"), "--n_boot", "200", "--topk", "20",
                  "--out_dir", str(roots[pkg] / "cmp")] for pkg in roots}
    _jax_cli(monkeypatch, jax_bootstrap.main, argv["jax"])
    bootstrap_compare.main(argv["port"])
    for rel in ("gnn/runB/bootstrap_compare.json", "gnn/runB/bootstrap_compare_runA.json",
                "gnn/runA/bootstrap_compare_runB.json", "cmp/bootstrap_compare.json"):
        assert _read(roots["port"] / rel) == _read(roots["jax"] / rel), rel


@pytest.mark.parametrize("mode", ["logit", "prob"])
def test_evaluate_ensemble_matches_jax(env, tmp_path, monkeypatch, mode):
    out = {pkg: tmp_path / pkg / "ens_ab" for pkg in ("jax", "port")}
    argv = {pkg: ["--run_a", env["runA"], "--run_b", env["runB"], "--out_dir",
                  str(out[pkg]), "--mode", mode, "--topk", "20"] for pkg in out}
    _jax_cli(monkeypatch, jax_ensemble.main, argv["jax"])
    evaluate_ensemble.main(argv["port"])
    for split in ("val", "test"):
        for name in ("scores", "y", "node_idx", "timestep"):
            f = f"{name}_{split}.npy"
            np.testing.assert_array_equal(np.load(out["port"] / f), np.load(out["jax"] / f))
    got, want = (json.loads(_read(out[k] / "metrics.json")) for k in ("port", "jax"))
    assert got == want
    assert got["ensemble_mode"] == mode
    got, want = (yaml.safe_load(_read(out[k] / "config_used.yaml")) for k in ("port", "jax"))
    assert got == want


def test_eda_matches_jax(env, tmp_path, monkeypatch, capsys):
    out = {pkg: tmp_path / pkg for pkg in ("jax", "port")}
    argv = {pkg: ["--processed_dir", env["processed"], "--out_dir", str(out[pkg]),
                  "--assert_no_cross_time_edges"] for pkg in out}
    _jax_cli(monkeypatch, jax_eda.main, argv["jax"])
    want_out = capsys.readouterr().out
    eda.main(argv["port"])
    got_out = capsys.readouterr().out
    assert got_out.replace(str(out["port"]), "") == want_out.replace(str(out["jax"]), "")
    assert "no cross-timestep edges" in got_out
    for name in ("degree_hist.csv", "labels_by_time.csv"):
        assert _read(out["port"] / name) == _read(out["jax"] / name), name


def test_sweep_matches_jax(env, tmp_path, monkeypatch):
    template = tmp_path / "template.yaml"
    template.write_text(yaml.safe_dump(dict(env["base"], run_name="sw", max_epochs=2)))
    monkeypatch.chdir(REPO)  # `python -m` of each package resolves from the root
    monkeypatch.setenv("EGNN_PLATFORM", "cpu")
    rows = {}
    for pkg, main in (("jax", jax_sweep.main), ("port", sweep.main)):
        argv = ["--template", str(template), "--param", "hidden_dim", "8", "12",
                "--out", str(tmp_path / pkg / "sweep.csv"),
                "--output_root", str(tmp_path / pkg / "outputs"), "--jobs", "2"]
        if pkg == "jax":
            _jax_cli(monkeypatch, main, argv)
        else:
            main(argv)
        with open(tmp_path / pkg / "sweep.csv") as f:
            rows[pkg] = list(csv.DictReader(f))
    assert [r["run_name"] for r in rows["port"]] == ["sw_hidden_dim8", "sw_hidden_dim12"]
    assert set(rows["port"][0]) - {"epochs_per_sync"} == set(rows["jax"][0])
    for got, want in zip(rows["port"], rows["jax"]):
        for k in ("run_name", "hidden_dim", "run_status", "n_test", "epochs_run"):
            assert got[k] == want[k], k
        assert got["run_status"] == "ok"
    assert os.path.exists(tmp_path / "port" / "outputs" / "gnn" / "sw_hidden_dim12" /
                          "best.ckpt")
    assert Path(tmp_path / "port" / "sweep.csv").stat().st_size > 0
