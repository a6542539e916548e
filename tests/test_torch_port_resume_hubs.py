"""Port parity of `resume.ckpt` and of the hub ablation and robustness
analyses.

Resume: a resume.ckpt written by either package is resumed by the other
(params, BN state, Adam moments and count, epoch, best); the continued runs
of both packages from one file log the same epochs. The best model is kept
across a resume whose later epochs never beat it, in both loops, and a
legacy file without best entries resets best_val to -1.

Hub ablation (`ablate_hubs_frac` inline) and the two CLIs
(analysis.hub_ablation, analysis.robustness) on one run dir: the port's
files against the JAX package's.

Tolerances: checkpoint arrays exactly (both sides write and read the same
f32 arrays); continued runs loss rtol 1e-4 and val PR-AUC atol 2e-3, as
test_torch_port_train.py; analysis metrics atol 2e-3 (the refitted
temperature, a scale, rtol 2e-3), counts exactly."""
import csv
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.analysis import hub_ablation as jax_hub
from elliptic_gnn_tpu.analysis import robustness as jax_robust
from elliptic_gnn_tpu.graph import build_graph as jax_build_graph
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu.train import checkpoint as jax_ckpt
from elliptic_gnn_tpu.train import train_gnn as jax_train
from elliptic_gnn_tpu_torch.analysis import hub_ablation, robustness
from elliptic_gnn_tpu_torch.models.convert import params_to_jax
from elliptic_gnn_tpu_torch.train import checkpoint, train_gnn
from tests.port_native_pin import same_native
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True, scope="module")
def _same_native():
    same_native()


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    cfg = {"seed": 0, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
           "synthetic": True, "synthetic_nodes": 1500,
           "processed_dir": str(root / "processed"), "data_dir": str(root / "raw")}
    jax_build_graph.main(cfg)
    return cfg["processed_dir"]


def _cfg(processed_dir, out, **kw):
    cfg = {
        "run_name": "run", "seed": 0, "processed_dir": processed_dir,
        "output_root": str(out), "device": "cpu", "arch": "sage_resbn",
        "hidden_dim": 16, "layers": 3, "dropout": 0.0, "lr": 0.01,
        "weight_decay": 5e-5, "grad_clip": 1.0, "max_epochs": 6,
        "patience": 30, "class_weight_pos": "auto", "amp": False,
        "use_val_for_thresholds": True, "precision_target": 0.0, "topk": 20,
        "calibrate_temperature": True, "symmetrize_edges": True,
        "time_embed_dim": 4, "time_embed_type": "learned", "max_timestep": 16,
        "train_window_k": 8, "epochs_per_sync": 1,
    }
    cfg.update(kw)
    return cfg


def _outdir(cfg):
    return os.path.join(cfg["output_root"], "gnn", cfg["run_name"])


def _log(cfg):
    with open(os.path.join(_outdir(cfg), "training_log.csv")) as f:
        rows = list(csv.DictReader(f))
    return ([int(r["epoch"]) for r in rows],
            np.array([float(r["train_loss"]) for r in rows]),
            np.array([float(r["val_pr_auc"]) for r in rows]))


def _jax_init(cfg):
    data = jax_train.prepare_data(cfg)
    model = jax_build_model(cfg["arch"], data.num_features, cfg)
    params, state = model.init(jax.random.key(cfg["seed"]))
    return model, params, state


def _port_state(cfg):
    """A port model and optimizer built for cfg, and a best-model dict."""
    data = train_gnn.prepare_data(cfg)
    data, model, _, opt, _ = train_gnn.build_train_state(
        cfg, data, cfg["seed"], torch.device("cpu"))
    best = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return model, opt, best


def _port_view(model, opt, best):
    """The port's loaded state in the JAX pytrees: (params, state, mu, nu,
    count, best_params, best_state)."""
    params, state = params_to_jax(model)
    mu = params_to_jax(model, take=checkpoint._moment(opt.state, "exp_avg"))[0]
    nu = params_to_jax(model, take=checkpoint._moment(opt.state, "exp_avg_sq"))[0]
    counts = {float(st["step"]) for st in opt.state.values()}
    best_params, best_state = params_to_jax(model, take=checkpoint._by_id(model, best))
    return params, state, mu, nu, counts, best_params, best_state


def _assert_trees_equal(a, b, what):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) > 0, what
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32), err_msg=what)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_ckpt_across_packages(processed, tmp_path, writer):
    """One package writes resume.ckpt at epoch 6 (checkpoint_every 3); the
    other's load_resume restores the same arrays, count, epoch and best;
    both packages then resume from copies of the file to epoch 9 and log
    the same epochs 7-9."""
    cfg = _cfg(processed, tmp_path / "first", checkpoint_every=3)
    _, params0, state0 = _jax_init(cfg)
    if writer == "jax":
        jax_train.main(dict(cfg))
    else:
        to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        train_gnn.main(dict(cfg), init_params=(to_np(params0), to_np(state0)))
    src = _outdir(cfg)
    assert os.path.exists(os.path.join(src, "resume.ckpt"))

    opt0 = jax_train.make_optimizer(cfg).init(params0)
    (p_j, s_j, o_j, ep_j, bv_j, bad_j, bp_j, bs_j) = jax_ckpt.load_resume(
        src, params0, state0, opt0)
    model, opt, best = _port_state(cfg)
    ep_p, bv_p, bad_p, _ = checkpoint.load_resume(src, model, opt, cfg, best)
    params, state, mu, nu, counts, best_params, best_state = _port_view(model, opt, best)
    adam = o_j[checkpoint.adam_index(cfg)]
    assert (ep_p, bad_p) == (ep_j, bad_j) == (6, bad_j) and bv_p == bv_j
    assert counts == {float(adam.count)} == {6.0}
    _assert_trees_equal(params, p_j, "params")
    _assert_trees_equal(state, s_j, "state")
    _assert_trees_equal(mu, adam.mu, "mu")
    _assert_trees_equal(nu, adam.nu, "nu")
    _assert_trees_equal(best_params, bp_j, "best_params")
    _assert_trees_equal(best_state, bs_j, "best_state")

    logs = {}
    for name, main in (("jax", jax_train.main), ("port", train_gnn.main)):
        root = tmp_path / f"resumed_{name}"
        shutil.copytree(src, os.path.join(root, "gnn", cfg["run_name"]))
        cfg2 = dict(cfg, output_root=str(root), max_epochs=9, resume=True)
        main(dict(cfg2))
        logs[name] = _log(cfg2)
    (ep_a, loss_a, pr_a), (ep_b, loss_b, pr_b) = logs["jax"], logs["port"]
    assert ep_a == ep_b == list(range(1, 10))
    np.testing.assert_allclose(loss_b[6:], loss_a[6:], rtol=1e-4)
    np.testing.assert_allclose(pr_b[6:], pr_a[6:], atol=2e-3)


@pytest.mark.parametrize("k", [1, 2])
def test_resume_keeps_best_model(processed, tmp_path, k):
    """A stored best no later epoch can beat (best_val 1.0) survives a
    resume: best.ckpt is the stored best model, in the serial and the K
    loop."""
    cfg = _cfg(processed, tmp_path, epochs_per_sync=k)
    model, opt, best = _port_state(cfg)
    train_gnn.main(dict(cfg, max_epochs=2, checkpoint_every=2))
    out = _outdir(cfg)
    checkpoint.load_resume(out, model, opt, cfg, best)
    marked = {n: (t + 0.5 if t.is_floating_point() else t) for n, t in best.items()}
    checkpoint.save_resume(out, model, opt.state, cfg, 2, 1.0, 0, best=marked)
    metrics = train_gnn.main(dict(cfg, max_epochs=4, resume=True))
    assert metrics["best_val_pr_auc"] == 1.0 and metrics["epochs_run"] == 2
    with np.load(os.path.join(out, "best.ckpt")) as z:
        saved = {k: z[k] for k in z.files}
    want = checkpoint.flatten(dict(zip(
        ("params", "state"), params_to_jax(model, take=checkpoint._by_id(model, marked)))))
    assert sorted(saved) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(saved[name], want[name], err_msg=name)


def test_resume_legacy_file_resets_best(processed, tmp_path):
    """A resume.ckpt without best entries (an older layout): best_val -1,
    best = the current model; the JAX package reads the same file the same
    way."""
    cfg = _cfg(processed, tmp_path, max_epochs=2, checkpoint_every=2)
    train_gnn.main(dict(cfg))
    path = os.path.join(_outdir(cfg), "resume.ckpt")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("best_")}
    with open(path, "wb") as fh:
        np.savez(fh, **flat)
    model, opt, best = _port_state(cfg)
    ep, bv, bad, _ = checkpoint.load_resume(_outdir(cfg), model, opt, cfg, best)
    assert (ep, bv) == (2, -1.0)
    for name, t in model.state_dict().items():
        assert torch.equal(best[name], t), name
    _, params0, state0 = _jax_init(cfg)
    opt0 = jax_train.make_optimizer(cfg).init(params0)
    out_j = jax_ckpt.load_resume(_outdir(cfg), params0, state0, opt0)
    assert out_j[3:5] == (2, -1.0)
    _assert_trees_equal(out_j[6], params_to_jax(model)[0], "legacy best = current")


def _close_json(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(b[k], int):
            assert a[k] == b[k], k
        elif k == "temperature":  # a scale, held relatively
            np.testing.assert_allclose(a[k], b[k], rtol=2e-3, err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], atol=2e-3, err_msg=k)


# a configuration that learns on the small graph (the tests above train a
# learned time embedding, whose scores collapse here; their checks do not
# depend on it)
LEARNS = dict(time_embed_dim=2, time_embed_type="sin", lr=0.02)


def test_hub_ablation_inline_matches_jax(processed, tmp_path):
    cfg = _cfg(processed, tmp_path / "jax", arch="sage", layers=2, hidden_dim=16,
               time_embed_dim=0, max_epochs=5, ablate_hubs_frac=0.05, lr=0.02)
    jax_train.main(dict(cfg))
    _, params0, state0 = _jax_init(cfg)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    cfg_p = dict(cfg, output_root=str(tmp_path / "port"))
    train_gnn.main(dict(cfg_p), init_params=(to_np(params0), to_np(state0)))
    got, want = (json.load(open(os.path.join(_outdir(c), "metrics_hub_removed.json")))
                 for c in (cfg_p, cfg))
    _close_json(got, want)
    assert got["n_hubs"] == 75 and got["n_edges_remaining"] < 2 * 1447


def test_analysis_clis_match_jax(processed, tmp_path, monkeypatch):
    """hub_ablation and robustness (edge drop and feature noise) on one JAX
    run dir: each package's CLI on its own copy, files compared."""
    cfg = _cfg(processed, tmp_path / "run", max_epochs=4, **LEARNS)
    jax_train.main(dict(cfg))
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(_outdir(cfg), dirs[name])
    hub_args = ["--frac", "0.05"]
    rob_args = ["--drop_frac", "0.2", "--noise_std", "0.1", "--seed", "3"]
    for tool, args in ((jax_hub, hub_args), (jax_robust, rob_args)):
        monkeypatch.setattr(sys, "argv", [tool.__name__, "--run_dir", dirs["jax"]] + args)
        tool.main()
    hub_ablation.main(["--run_dir", dirs["port"]] + hub_args)
    robustness.main(["--run_dir", dirs["port"]] + rob_args)
    for name in ("metrics_hub_removed_0p05.json", "robustness_drop0.2_noise0.1.json"):
        got, want = (json.load(open(os.path.join(dirs[k], name))) for k in ("port", "jax"))
        _close_json(got, want)
