"""Port parity of the K-epoch loop (`epochs_per_sync`): the device PR-AUC
against the host one and the JAX package's, the port's K = 4 loop against
its serial loop (stop inside a block, dropout on), and against the JAX
trainer's K = 4 loop from carried-over weights. On the CPU the K loop runs
its epoch body eagerly (a CUDA graph needs the card; tests/test_torch_port_cuda.py
holds the captured loop against the serial one there).

Tolerances: device PR-AUC 1e-6 (f32 sums of at most 300 terms); K against
serial 1e-5 on every logged value and final metric, as
tests/test_train.py::test_epochs_per_sync_scan_matches_serial requires of
the JAX package; port against JAX those of test_torch_port_train.py (loss
rtol 1e-4, PR-AUC and test metrics atol 2e-3), at its lr of 0.01: over 14
epochs at lr 0.02 the f32 differences move the fitted temperature enough
to shift the test ECE by 4e-3."""
import csv
import os

import jax
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.graph import build_graph as jax_build_graph
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu.train import train_gnn as jax_train
from elliptic_gnn_tpu.utils import metrics as jax_metrics
from elliptic_gnn_tpu_torch.train import train_gnn
from elliptic_gnn_tpu_torch.utils import metrics as M
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
        "run_name": "kloop", "seed": 0, "processed_dir": processed_dir,
        "output_root": str(out), "device": "cpu", "arch": "sage_resbn",
        "hidden_dim": 16, "layers": 3, "dropout": 0.2, "lr": 0.02,
        "weight_decay": 5e-5, "grad_clip": 1.0, "max_epochs": 20,
        "patience": 3, "class_weight_pos": "auto", "amp": False,
        "use_val_for_thresholds": True, "precision_target": 0.0, "topk": 20,
        "calibrate_temperature": True, "symmetrize_edges": True,
        "time_embed_dim": 2, "time_embed_type": "sin", "max_timestep": 16,
        "train_window_k": 8,
    }
    cfg.update(kw)
    return cfg


def _log(cfg):
    path = os.path.join(cfg["output_root"], "gnn", cfg["run_name"], "training_log.csv")
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return ([int(r["epoch"]) for r in rows],
            np.array([float(r["train_loss"]) for r in rows]),
            np.array([float(r["val_pr_auc"]) for r in rows]))


def test_device_pr_auc_matches_host_and_jax():
    """Against the host metric and the JAX package's device metric, jitted:
    one compile a length in place of one an op (the same values as eager,
    bit for bit, on these inputs)."""
    jax_device = jax.jit(jax_metrics.pr_auc_illicit_device)
    rng = np.random.default_rng(1)
    for _ in range(20):
        n = int(rng.integers(5, 300))
        y = (rng.random(n) < 0.25).astype(int)
        s = np.round(rng.random(n), int(rng.integers(1, 4))).astype(np.float32)
        got = M.pr_auc_illicit_device(torch.from_numpy(y), torch.from_numpy(s))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - M.pr_auc_illicit(y, s)) < 1e-6
        assert abs(float(got) - float(jax_device(y, s))) < 1e-6
    none = M.pr_auc_illicit_device(torch.zeros(8, dtype=torch.int64),
                                   torch.linspace(0, 1, 8))
    assert float(none) == 0.0
    assert float(M.pr_auc_illicit_device(torch.zeros(0), torch.zeros(0))) == 0.0


def test_epochs_per_sync_auto():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert train_gnn.epochs_per_sync({}, cpu) == 1
    assert train_gnn.epochs_per_sync({"epochs_per_sync": "auto"}, cuda) == 8
    assert train_gnn.epochs_per_sync({"epochs_per_sync": 4}, cpu) == 4
    assert train_gnn.epochs_per_sync({"epochs_per_sync": 1}, cuda) == 1


@pytest.mark.parametrize("arch,extra", [
    ("sage_resbn", {}),
    ("gat", {"hidden_dim": 16, "layers": 2, "heads": 2, "use_time_scalar": True,
             "time_embed_dim": 0, "symmetrize_edges": False}),
])
def test_k_loop_matches_serial(processed, tmp_path, arch, extra):
    """The stop falls inside a block (patience 3, blocks of 4): same rows,
    same stop epoch, same final metrics; dropout masks drawn in the same
    order by both loops."""
    cfg1 = _cfg(processed, tmp_path, arch=arch, run_name="serial",
                epochs_per_sync=1, **extra)
    cfg4 = dict(cfg1, run_name="k4", epochs_per_sync=4)
    m1 = train_gnn.main(dict(cfg1))
    m4 = train_gnn.main(dict(cfg4))
    ep1, loss1, pr1 = _log(cfg1)
    ep4, loss4, pr4 = _log(cfg4)
    assert ep1 == ep4 == list(range(1, m1["epochs_run"] + 1))
    assert m1["epochs_run"] < cfg1["max_epochs"] and m1["epochs_run"] % 4 != 0
    np.testing.assert_allclose(loss4, loss1, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pr4, pr1, rtol=0, atol=1e-5)
    for k in ("pr_auc_illicit", "roc_auc", "best_val_pr_auc", "epochs_run"):
        assert abs(float(m1[k]) - float(m4[k])) < 1e-5, k
    assert m4["epochs_per_sync"] == 4 and m1["epochs_per_sync"] == 1
    assert len(m4["epoch_seconds"]) == m4["epochs_run"]


def test_k_loop_matches_jax(processed, tmp_path):
    """The port's K = 4 loop and the JAX trainer's K = 4 scan, from the
    JAX model's init, dropout 0: per-epoch loss and val PR-AUC, stop epoch,
    test metrics."""
    kw = dict(dropout=0.0, epochs_per_sync=4, patience=3, max_epochs=14, lr=0.01)
    cfg_j = _cfg(processed, tmp_path / "jax", **kw)
    cfg_p = _cfg(processed, tmp_path / "port", **kw)
    m_j = jax_train.main(dict(cfg_j))
    data = jax_train.prepare_data(cfg_j)
    model = jax_build_model(cfg_j["arch"], data.num_features, cfg_j)
    params, state = model.init(jax.random.key(cfg_j["seed"]))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    m_p = train_gnn.main(dict(cfg_p), init_params=(to_np(params), to_np(state)))
    ep_j, loss_j, pr_j = _log(cfg_j)
    ep_p, loss_p, pr_p = _log(cfg_p)
    assert ep_p == ep_j and m_p["epochs_run"] == m_j["epochs_run"]
    np.testing.assert_allclose(loss_p, loss_j, rtol=1e-4)
    np.testing.assert_allclose(pr_p, pr_j, atol=2e-3)
    for k in ("pr_auc_illicit", "roc_auc", "best_val_pr_auc", "ece"):
        np.testing.assert_allclose(m_p[k], m_j[k], atol=2e-3, err_msg=k)
