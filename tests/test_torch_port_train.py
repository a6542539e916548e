"""Port parity for the slice as a whole: the torch trainer's train_gnn.main
on a tiny synthetic processed graph (device cpu, 3 epochs, dropout 0, the
JAX model's init parameters injected) against the JAX trainer on the same
config — per-epoch train loss and val PR-AUC, test metrics, and the
run-directory artifacts. Plus: the port imports without JAX, and
`device: auto` raises without a GPU.

Tolerances: loss rtol 1e-4 (f32 through a few epochs of Adam), PR-AUC and
test metrics atol 2e-3 (a score difference at f32 rounding can swap two
ranks), test scores atol 2e-3 at lr 0.01 and 1e-2 at lr 0.1 (see the
test)."""
import csv
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.graph import build_graph as jax_build_graph
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu.train import train_gnn as jax_train
from elliptic_gnn_tpu_torch.graph import build_graph
from elliptic_gnn_tpu_torch.train import train_gnn
from tests.port_native_pin import same_native
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = [
    "metrics.json", "scores_val.npy", "y_val.npy", "node_idx_val.npy",
    "timestep_val.npy", "scores_test.npy", "y_test.npy", "node_idx_test.npy",
    "timestep_test.npy", "config_used.yaml", "training_log.csv",
]


@pytest.fixture(autouse=True, scope="module")
def _same_native():
    same_native()


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    cfg = {"seed": 0, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
           "synthetic": True, "synthetic_nodes": 2500,
           "processed_dir": str(root / "processed"), "data_dir": str(root / "raw")}
    jax_build_graph.main(cfg)
    port_cfg = dict(cfg, processed_dir=str(root / "processed_port"))
    build_graph.main(port_cfg)
    return cfg["processed_dir"], port_cfg["processed_dir"]


def _cfg(processed_dir, out, **kw):
    cfg = {
        "run_name": "port_parity", "seed": 0, "processed_dir": processed_dir,
        "output_root": str(out), "device": "cpu", "arch": "sage_resbn",
        "hidden_dim": 16, "layers": 3, "dropout": 0.0, "lr": 0.01,
        "weight_decay": 5e-5, "grad_clip": 1.0, "max_epochs": 3,
        "patience": 30, "class_weight_pos": "auto", "amp": False,
        "use_val_for_thresholds": True, "precision_target": 0.0, "topk": 20,
        "calibrate_temperature": True, "symmetrize_edges": True,
        "time_embed_dim": 2, "time_embed_type": "sin", "max_timestep": 16,
        "train_window_k": 8,
    }
    cfg.update(kw)
    return cfg


def _log(outdir):
    with open(os.path.join(outdir, "training_log.csv")) as f:
        rows = list(csv.DictReader(f))
    return (np.array([float(r["train_loss"]) for r in rows]),
            np.array([float(r["val_pr_auc"]) for r in rows]))


def test_processed_graphs_identical(processed):
    a, b = (np.load(os.path.join(p, "graph.npz")) for p in processed)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("max_epochs,patience,lr,score_atol",
                         [(3, 30, 0.01, 2e-3), (10, 1, 0.1, 1e-2)])
def test_train_main_matches_jax_trainer(processed, tmp_path, max_epochs, patience,
                                        lr, score_atol):
    """(3, 30) runs every epoch; (10, 1) at lr 0.1 stops early, through the
    loop's one-epoch lag. Adam's first steps are sign-like (m/sqrt(v) ~ +-1),
    so a gradient near zero that differs in its last bits moves a weight by
    +-lr: at lr 0.1 that reaches ~1e-2 in the calibrated test scores."""
    kw = dict(max_epochs=max_epochs, patience=patience, lr=lr)
    cfg_j = _cfg(processed[0], tmp_path / "jax", **kw)
    cfg_p = _cfg(processed[0], tmp_path / "port", **kw)
    m_j = jax_train.main(dict(cfg_j))

    # the JAX trainer initialises from jax.random.key(seed): carry it over
    data = jax_train.prepare_data(cfg_j)
    model = jax_build_model(cfg_j["arch"], data.num_features, cfg_j)
    params, state = model.init(jax.random.key(cfg_j["seed"]))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    m_p = train_gnn.main(dict(cfg_p), init_params=(to_np(params), to_np(state)))

    out_j = os.path.join(cfg_j["output_root"], "gnn", cfg_j["run_name"])
    out_p = os.path.join(cfg_p["output_root"], "gnn", cfg_p["run_name"])
    for a in ARTIFACTS:
        assert os.path.exists(os.path.join(out_p, a)), f"missing {a}"
    loss_j, pr_j = _log(out_j)
    loss_p, pr_p = _log(out_p)
    assert len(loss_p) == len(loss_j) == m_j["epochs_run"] == m_p["epochs_run"]
    assert (m_p["epochs_run"] == max_epochs) == (patience > max_epochs)
    np.testing.assert_allclose(loss_p, loss_j, rtol=1e-4)
    np.testing.assert_allclose(pr_p, pr_j, atol=2e-3)
    for k in ("pr_auc_illicit", "roc_auc", "best_val_pr_auc", "ece"):
        np.testing.assert_allclose(m_p[k], m_j[k], atol=2e-3, err_msg=k)
    assert m_p["n_test"] == m_j["n_test"]
    for name in ("node_idx_test.npy", "y_test.npy", "timestep_test.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(out_p, name)),
                                      np.load(os.path.join(out_j, name)))
    np.testing.assert_allclose(np.load(os.path.join(out_p, "scores_test.npy")),
                               np.load(os.path.join(out_j, "scores_test.npy")),
                               atol=score_atol)


def test_device_auto_raises_without_gpu(processed, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        train_gnn.main(_cfg(processed[1], tmp_path, device="auto"))


def test_unported_option_raises(processed, tmp_path):
    # a pinned single-device encoding on a mesh, once refused, is the GSPMD
    # row sharding: main starts two ranks, each gathers its own rows over
    # the all-gathered ELL rows, and the run matches the single-device one
    m2 = train_gnn.main(_cfg(processed[1], tmp_path, run_name="ell_mesh2",
                             mesh_devices=2, aggregation="ell"))
    one = train_gnn.main(_cfg(processed[1], tmp_path, run_name="ell_one",
                              aggregation="ell"))
    assert m2["mesh_devices"] == 2 and m2["epochs_run"] == one["epochs_run"]
    for key in ("pr_auc_illicit", "best_val_pr_auc"):
        assert abs(m2[key] - one[key]) < 2e-3, key
    # an aggregation the JAX package does not have is still refused
    with pytest.raises(ValueError, match="Unknown aggregation"):
        train_gnn.main(_cfg(processed[1], tmp_path, aggregation="csr"))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "for m in ('jax', 'jaxlib', 'optax', 'elliptic_gnn_tpu', 'pandas'):\n"
        "    sys.modules[m] = None\n"
        "import elliptic_gnn_tpu_torch.train.train_gnn\n"
        "import elliptic_gnn_tpu_torch.kernels.bsda_spmm_cuda\n"
        "import elliptic_gnn_tpu_torch.kernels.gat_cuda\n"
        "import elliptic_gnn_tpu_torch.kernels.packed_gat\n"
        "import elliptic_gnn_tpu_torch.train.predict\n"
        "import elliptic_gnn_tpu_torch.analysis.common\n"
        "import elliptic_gnn_tpu_torch.graph.build_graph\n"
        "import elliptic_gnn_tpu_torch.graph.ingest\n"
        "import elliptic_gnn_tpu_torch.analysis.hub_ablation\n"
        "import elliptic_gnn_tpu_torch.analysis.robustness\n"
        "import elliptic_gnn_tpu_torch.models.convert\n"
        "import elliptic_gnn_tpu_torch.analysis.run_all\n"
        "import elliptic_gnn_tpu_torch.analysis.bootstrap_compare\n"
        "import elliptic_gnn_tpu_torch.analysis.evaluate_ensemble\n"
        "import elliptic_gnn_tpu_torch.analysis.eda\n"
        "import elliptic_gnn_tpu_torch.analysis.sweep\n"
        "import elliptic_gnn_tpu_torch.analysis.treeshap\n"
        "import elliptic_gnn_tpu_torch.train.train_baselines\n"
        "import elliptic_gnn_tpu_torch.train.sampler\n"
        "import elliptic_gnn_tpu_torch.sweeps.sweep_gnn\n"
        "import elliptic_gnn_tpu_torch.parallel.multihost\n"
        "import elliptic_gnn_tpu_torch.parallel.shardmap_step\n"
        "import elliptic_gnn_tpu_torch.parallel.gspmd_step\n"
        "from elliptic_gnn_tpu_torch.graph.synthetic import write_raw_csvs\n"
        "from elliptic_gnn_tpu_torch.kernels import (segment_sum, segment_mean, segment_max,\n"
        "    segment_softmax, spmm_edge_list, build_ell_graph)\n"
        "import elliptic_gnn_tpu_torch.utils as u\n"
        "assert u.metrics.pr_auc_illicit and u.common.set_seed\n"
        "import elliptic_gnn_tpu_torch.kernels.segment\n"
        "import elliptic_gnn_tpu_torch.sweeps._worker\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'elliptic_gnn_tpu', 'pandas')\n"
        "       and sys.modules[m] is not None and m not in before]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernels_import_no_higher_layer():
    """The kernel layer knows no layer above it: no module of
    elliptic_gnn_tpu_torch/kernels imports parallel/, models/ or train/
    (an encoding answers for its own aggregation; kernels/encoding.py)."""
    import ast

    above = ("parallel", "models", "train")
    pkg = "elliptic_gnn_tpu_torch"
    kdir = os.path.join(REPO, pkg, "kernels")
    found = []
    for name in sorted(os.listdir(kdir)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(kdir, name)) as fh:
            tree = ast.parse(fh.read(), name)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
                if node.level == 2 and not node.module:  # from .. import parallel
                    mods = [a.name for a in node.names]
                elif node.level == 0:
                    mods = [m[len(pkg) + 1:] for m in mods if m.startswith(pkg + ".")]
                elif node.level != 2:
                    continue
            elif isinstance(node, ast.Import):
                mods = [a.name[len(pkg) + 1:] for a in node.names
                        if a.name.startswith(pkg + ".")]
            else:
                continue
            found += [f"{name}:{node.lineno} {m}" for m in mods
                      if m.split(".")[0] in above]
    assert not found, found
