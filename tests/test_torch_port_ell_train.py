"""Port parity of the trainer's `aggregation: ell` path and the rest of its
single-device options against the JAX package, on the CPU at a few hundred
labelled nodes:

  - renumber_for_ell: rank, nbrs and rows exactly equal to JAX's for sage,
    gcn and gat; ell_spmm on the renumbered graph within 1e-6, absolute
    plus relative (f32 sums of up to 41 terms, in another order);
  - _pick_aggregation: the same choice (or the same ValueError) as JAX over
    a grid of aggregation, use_pallas, mini_batch and kind;
  - train_gnn.main with `aggregation: ell` against the JAX trainer (the JAX
    model's init injected, dropout 0, 3 epochs), sage_resbn with a time
    embedding and gat: loss rtol 1e-4, val PR-AUC and test metrics atol
    2e-3, test scores atol 2e-3 (test_torch_port_train.py's tolerances);
  - predict on that port run dir reproduces its scores within 1e-6;
  - profile_dir writes a Chrome trace of the K loop's blocks 4-6 with the
    `loop.*` spans' annotations and the spans beside it, and `auto` K stays
    8 on the card where a trace is asked for.
Both packages' native libraries are pinned to one state
(tests/port_native_pin.py): build_csr sorts through them."""
import csv
import itertools
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.graph import build_graph as jax_build_graph
from elliptic_gnn_tpu.kernels import ell as jax_ell
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu.models import prepare_graph_ops as jax_prepare
from elliptic_gnn_tpu.train import train_gnn as jax_train
from elliptic_gnn_tpu_torch.kernels import ell
from elliptic_gnn_tpu_torch.models import prepare_graph_ops
from elliptic_gnn_tpu_torch.train import predict, train_gnn
from tests.port_native_pin import same_native
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

ARCHS = {
    "sage_resbn": dict(arch="sage_resbn", hidden_dim=16, layers=3,
                       time_embed_dim=2, time_embed_type="sin"),
    "gat": dict(arch="gat", hidden_dim=16, heads=2, layers=2, time_embed_dim=0,
                use_time_scalar=True),
}


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
    return cfg["processed_dir"]


def _cfg(processed_dir, out, **kw):
    cfg = {
        "run_name": "port_ell", "seed": 0, "processed_dir": processed_dir,
        "output_root": str(out), "device": "cpu", "dropout": 0.0, "lr": 0.01,
        "weight_decay": 5e-5, "grad_clip": 1.0, "max_epochs": 3,
        "patience": 30, "class_weight_pos": "auto", "amp": False,
        "use_val_for_thresholds": True, "precision_target": 0.0, "topk": 20,
        "calibrate_temperature": True, "symmetrize_edges": True,
        "max_timestep": 16, "train_window_k": 8,
    }
    cfg.update(kw)
    return cfg


def _log(outdir):
    with open(os.path.join(outdir, "training_log.csv")) as f:
        rows = list(csv.DictReader(f))
    return (np.array([float(r["train_loss"]) for r in rows]),
            np.array([float(r["val_pr_auc"]) for r in rows]))


def run_both(processed_dir, tmp_path, **kw):
    """The JAX trainer and the port's on one config, the port starting from
    the JAX model's init. Returns (JAX metrics, port metrics, JAX run dir,
    port run dir)."""
    cfg_j = _cfg(processed_dir, tmp_path / "jax", **kw)
    cfg_p = _cfg(processed_dir, tmp_path / "port", **kw)
    m_j = jax_train.main(dict(cfg_j))
    data = jax_train.prepare_data(cfg_j)
    model = jax_build_model(cfg_j["arch"], data.num_features, cfg_j)
    params, state = model.init(jax.random.key(cfg_j["seed"]))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    m_p = train_gnn.main(dict(cfg_p), init_params=(to_np(params), to_np(state)))
    return (m_j, m_p, os.path.join(cfg_j["output_root"], "gnn", cfg_j["run_name"]),
            os.path.join(cfg_p["output_root"], "gnn", cfg_p["run_name"]))


def assert_runs_match(m_j, m_p, out_j, out_p):
    loss_j, pr_j = _log(out_j)
    loss_p, pr_p = _log(out_p)
    assert len(loss_p) == len(loss_j) == m_j["epochs_run"] == m_p["epochs_run"]
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
                               atol=2e-3)


@pytest.mark.parametrize("kind", ["sage", "gcn", "gat"])
def test_renumber_for_ell_matches_jax(kind):
    rng = np.random.default_rng(3)
    n = 400
    ei = rng.integers(0, n, (2, 1200))
    ei[1, :40] = 7  # a hub destination: a wide bucket
    g_j, rank_j = jax_ell.renumber_for_ell(jax_prepare(ei, n, kind))
    g_p, rank_p = ell.renumber_for_ell(prepare_graph_ops(ei, n, kind))
    assert rank_p.dtype == rank_j.dtype
    np.testing.assert_array_equal(rank_p, rank_j)
    assert g_p.inv_perm is None and g_j.inv_perm is None
    assert g_p.widths == g_j.widths and g_p.n_zero_deg == g_j.n_zero_deg
    for a, b in zip(g_j.nbrs + g_j.rows, g_p.nbrs + g_p.rows):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    x = rng.standard_normal((n, 8)).astype(np.float32)
    np.testing.assert_allclose(ell.ell_spmm(g_p, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_ell.ell_spmm(g_j, x)),
                               rtol=1e-6, atol=1e-6)
    # a renumbered graph is left as it is
    again, rank = ell.renumber_for_ell(g_p)
    assert again is g_p
    np.testing.assert_array_equal(rank, np.arange(n))


def test_pick_aggregation_matches_jax():
    grid = itertools.product(
        ["auto", "bsda", "bsda_pallas", "ell", "shard_map", "csr"],
        [False, True], [False, True], ["sage", "gcn", "gat"])
    for agg, use_pallas, mini_batch, kind in grid:
        cfg = {"aggregation": agg, "use_pallas": use_pallas, "mini_batch": mini_batch}
        try:
            want = jax_train._pick_aggregation(cfg, None, kind)
        except ValueError as exc:
            with pytest.raises(ValueError, match=re.escape(str(exc))):
                train_gnn._pick_aggregation(cfg, kind)
            continue
        assert train_gnn._pick_aggregation(cfg, kind) == want, cfg


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_ell_trainer_matches_jax_and_predict(processed, tmp_path, arch):
    m_j, m_p, out_j, out_p = run_both(processed, tmp_path, aggregation="ell",
                                      **ARCHS[arch])
    assert_runs_match(m_j, m_p, out_j, out_p)
    # predict rebuilds the ELL encoding the run trained on
    node_idx, probs, _, _, _ = predict.predict(out_p)
    idx = np.load(os.path.join(out_p, "node_idx_test.npy"))
    np.testing.assert_array_equal(node_idx, np.arange(node_idx.size))
    np.testing.assert_allclose(probs[idx],
                               np.load(os.path.join(out_p, "scores_test.npy")),
                               atol=1e-6)


def test_profile_dir_writes_trace(processed, tmp_path):
    """The K loop (K = 2 pinned; on the CPU its body runs eagerly) traces
    its fourth to sixth blocks: the trace holds the host's ATen ops and the
    `loop.*` spans' annotations, <run_name>.spans.json the recorder's spans
    with the set-up's. On the card `auto` stays K = 8 under a trace."""
    prof_dir = tmp_path / "prof"
    cfg = _cfg(processed, tmp_path, run_name="traced", max_epochs=12, epochs_per_sync=2,
               profile_dir=str(prof_dir), **ARCHS["sage_resbn"])
    train_gnn.main(cfg)
    with open(prof_dir / "traced.trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    blocks = [e for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == "loop.block"]
    assert len(blocks) == 3
    assert {"loop.launch", "loop.sync", "loop.tail"} <= names
    with open(prof_dir / "traced.spans.json") as f:
        spans = json.load(f)["spans"]
    mine = [s for s in spans if s["name"] in ("setup.build", "setup.order", "setup.tables",
                                               "setup.model", "setup.prepare")]
    build = [s for s in mine if s["name"] == "setup.build"][-1]
    assert {s["name"] for s in mine if s["parent"] == build["id"]} == {
        "setup.order", "setup.tables", "setup.model"}
    assert any(s["name"] == "setup.prepare" for s in mine)
    assert [s["attrs"]["block"] for s in spans if s["name"] == "loop.block"][-3:] == [3, 4, 5]
    with open(tmp_path / "gnn" / "traced" / "training_log.csv") as f:
        assert len(f.read().splitlines()) == 1 + 12
    # on the card `auto` is K = 8, a trace asked for or not; an integer pins K
    cuda = torch.device("cuda")
    assert train_gnn.epochs_per_sync({"profile_dir": "p"}, cuda) == 8
    assert train_gnn.epochs_per_sync({}, cuda) == 8
    assert train_gnn.epochs_per_sync({"profile_dir": "p", "epochs_per_sync": 4}, cuda) == 4


def test_profile_dir_serial_writes_trace(processed, tmp_path):
    """The serial loop (`epochs_per_sync: 1`) traces its fourth to sixth
    epochs: the trace holds the host's ATen ops and no `loop.*` annotation,
    <run_name>.spans.json the set-up's spans and no `loop.block`."""
    prof_dir = tmp_path / "prof"
    cfg = _cfg(processed, tmp_path, run_name="serial", max_epochs=7, epochs_per_sync=1,
               profile_dir=str(prof_dir), **ARCHS["sage_resbn"])
    assert train_gnn.main(cfg)["epochs_per_sync"] == 1
    with open(prof_dir / "serial.trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert not any(n.startswith("loop.") for n in names)
    with open(prof_dir / "serial.spans.json") as f:
        spans = json.load(f)["spans"]
    build = [s for s in spans if s["name"] == "setup.build"][-1]
    assert {s["name"] for s in spans if s["parent"] == build["id"]} == {
        "setup.order", "setup.tables", "setup.model"}
    assert not any(s["name"] == "loop.block" and s["start_ns"] > build["end_ns"]
                   for s in spans)
    with open(tmp_path / "gnn" / "serial" / "training_log.csv") as f:
        assert len(f.read().splitlines()) == 1 + 7
