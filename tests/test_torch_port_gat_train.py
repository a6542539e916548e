"""Port parity for the GAT slice as a whole: the torch trainer's
train_gnn.main on a tiny synthetic processed graph (device cpu, 3 epochs,
dropout 0, the JAX model's init parameters injected) against the JAX
trainer on the same config, epoch by epoch; then best.ckpt round trip, in
the JAX npz layout both ways (the JAX checkpoint.load_best reads the port's
file, the port's predict scores the JAX run), and train.predict against
the run's own scores.

Tolerances as tests/test_torch_port_train.py: loss rtol 1e-4, PR-AUC and
test metrics atol 2e-3, test scores atol 2e-3; predict against
scores_test.npy atol 1e-6 (the same forward on the same tables); the
port's predict against the JAX predict on the JAX run atol 1e-4 (the same
weights, two implementations of the forward)."""
import csv
import os

import jax
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.graph import build_graph as jax_build_graph
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu.train import checkpoint as jax_checkpoint
from elliptic_gnn_tpu.train import predict as jax_predict
from elliptic_gnn_tpu.train import train_gnn as jax_train
from elliptic_gnn_tpu_torch.analysis import common
from elliptic_gnn_tpu_torch.models import build_model
from elliptic_gnn_tpu_torch.models.convert import params_to_jax
from elliptic_gnn_tpu_torch.train import checkpoint, predict, train_gnn
from tests.port_native_pin import same_native

GAT_CFG = {
    "run_name": "gat_parity", "seed": 0, "device": "cpu", "arch": "gat",
    "hidden_dim": 16, "heads": 4, "layers": 2, "dropout": 0.0, "lr": 0.01,
    "weight_decay": 1e-4, "grad_clip": 1.0, "max_epochs": 3, "patience": 60,
    "class_weight_pos": "auto", "amp": False, "use_val_for_thresholds": True,
    "precision_target": 0.75, "topk": 20, "symmetrize_edges": False,
    "use_time_scalar": True, "train_window_k": 10,
    # 3 epochs leave val logits that temperature scaling flattens to
    # P = 0.5 everywhere (T ~ 1e11): keep the scores informative
    "calibrate_temperature": False,
}


@pytest.fixture(autouse=True, scope="module")
def _same_native():
    same_native()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX run and one port run of the same GAT config; returns
    (cfg_j, cfg_p, metrics_j, metrics_p, out_j, out_p)."""
    root = tmp_path_factory.mktemp("gat")
    split = {"seed": 0, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
             "synthetic": True, "synthetic_nodes": 2500,
             "processed_dir": str(root / "processed"), "data_dir": str(root / "raw")}
    jax_build_graph.main(split)
    cfg_j = dict(GAT_CFG, processed_dir=split["processed_dir"],
                 output_root=str(root / "jax"))
    cfg_p = dict(cfg_j, output_root=str(root / "port"))
    m_j = jax_train.main(dict(cfg_j))

    data = jax_train.prepare_data(cfg_j)
    model = jax_build_model("gat", data.num_features, cfg_j)
    params, state = model.init(jax.random.key(cfg_j["seed"]))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    m_p = train_gnn.main(dict(cfg_p), init_params=(to_np(params), to_np(state)))
    out = [os.path.join(c["output_root"], "gnn", c["run_name"]) for c in (cfg_j, cfg_p)]
    return cfg_j, cfg_p, m_j, m_p, out[0], out[1]


def _log(outdir):
    with open(os.path.join(outdir, "training_log.csv")) as f:
        rows = list(csv.DictReader(f))
    return (np.array([float(r["train_loss"]) for r in rows]),
            np.array([float(r["val_pr_auc"]) for r in rows]))


def test_gat_trainer_matches_jax_trainer(runs):
    _, _, m_j, m_p, out_j, out_p = runs
    loss_j, pr_j = _log(out_j)
    loss_p, pr_p = _log(out_p)
    assert len(loss_p) == len(loss_j) == m_j["epochs_run"] == m_p["epochs_run"] == 3
    np.testing.assert_allclose(loss_p, loss_j, rtol=1e-4)
    np.testing.assert_allclose(pr_p, pr_j, atol=2e-3)
    for k in ("pr_auc_illicit", "roc_auc", "best_val_pr_auc", "ece"):
        np.testing.assert_allclose(m_p[k], m_j[k], atol=2e-3, err_msg=k)
    for name in ("node_idx_test.npy", "y_test.npy", "timestep_test.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(out_p, name)),
                                      np.load(os.path.join(out_j, name)))
    scores = np.load(os.path.join(out_p, "scores_test.npy"))
    assert scores.std() > 1e-3
    np.testing.assert_allclose(
        scores, np.load(os.path.join(out_j, "scores_test.npy")), atol=2e-3)


def test_gat_trainer_tables(runs):
    """Depth 4 and no transpose tables for GAT, depth 3 with them for sage."""
    cfg_p = runs[1]
    data = train_gnn.prepare_data(cfg_p)
    _, g = train_gnn.build_graph_ops(cfg_p, data, torch.device("cpu"))
    assert g.depth == 4 and g.transpose is None and g.slot_occ is not None
    _, g = train_gnn.build_graph_ops(dict(cfg_p, arch="sage_resbn"), data,
                                     torch.device("cpu"))
    assert g.depth == 3 and g.transpose is not None


def test_best_ckpt_round_trip(runs):
    cfg_p, out_p = runs[1], runs[5]
    data = train_gnn.prepare_data(cfg_p)
    fresh = build_model("gat", data.num_features, cfg_p,
                        generator=torch.Generator().manual_seed(123))
    before = [p.detach().clone() for p in fresh.parameters()]
    checkpoint.load_best(out_p, fresh)
    assert any(not torch.equal(a, b) for a, b in zip(before, fresh.parameters()))
    checkpoint.save_best(str(out_p), fresh)
    again = checkpoint.load_best(out_p, build_model("gat", data.num_features, cfg_p))
    for a, b in zip(fresh.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    wrong = build_model("gat", data.num_features, dict(cfg_p, hidden_dim=32))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load_best(out_p, wrong)
    deeper = build_model("gat", data.num_features, dict(cfg_p, layers=3))
    with pytest.raises(ValueError, match="shape mismatch for params/layers/1/w"):
        checkpoint.load_best(out_p, deeper)


def test_best_ckpt_is_the_jax_npz_layout(runs):
    """The JAX package's checkpoint.load_best reads the port's best.ckpt,
    and what it reads equals params_to_jax of the port model loaded from
    it, key for key and bit for bit."""
    cfg_j, cfg_p, out_p = runs[0], runs[1], runs[5]
    data = jax_train.prepare_data(cfg_j)
    p0, s0 = jax_build_model("gat", data.num_features, cfg_j).init(jax.random.key(1))
    params, state = jax_checkpoint.load_best(out_p, p0, s0)
    got = checkpoint.flatten({"params": jax.tree.map(np.asarray, params),
                              "state": jax.tree.map(np.asarray, state)})
    model = checkpoint.load_best(out_p, build_model("gat", data.num_features, cfg_p))
    want_p, want_s = params_to_jax(model)
    want = checkpoint.flatten({"params": want_p, "state": want_s})
    assert sorted(got) == sorted(want) == [
        f"params/layers/{i}/{n}" for i in range(2) for n in ("a_dst", "a_src", "b", "w")]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with np.load(os.path.join(out_p, "best.ckpt")) as z:
        assert sorted(z.files) == sorted(want)


def test_port_predict_scores_a_jax_run(runs):
    """The port's predict on the JAX run dir (its best.ckpt, its
    config_used.yaml) gives the JAX predict's probabilities."""
    out_j = runs[4]
    node_j, probs_j, flags_j, thr_j, _ = jax_predict.predict(out_j)
    node_p, probs_p, flags_p, thr_p, _ = predict.predict(out_j, device="cpu")
    np.testing.assert_array_equal(node_p, node_j)
    assert thr_p == thr_j and probs_p.std() > 1e-3
    np.testing.assert_allclose(probs_p, probs_j, atol=1e-4)
    near = np.abs(probs_j - thr_j) < 1e-4  # a flag may flip only at the threshold
    np.testing.assert_array_equal(flags_p[~near], flags_j[~near])


def test_best_ckpt_refuses_other_files(runs, tmp_path):
    """A torch.save file (the format of earlier port runs), a file that is
    no npz and an npz that lacks an entry raise with a message, and nothing
    falls back to torch.load."""
    cfg_p, out_p = runs[1], runs[5]
    data = train_gnn.prepare_data(cfg_p)
    model = build_model("gat", data.num_features, cfg_p)
    with np.load(os.path.join(out_p, "best.ckpt")) as z:
        flat = {k: z[k] for k in z.files if k != "params/layers/1/a_src"}
    np.savez(str(tmp_path / "best.npz"), **flat)
    os.replace(str(tmp_path / "best.npz"), str(tmp_path / "best.ckpt"))
    with pytest.raises(KeyError, match="params/layers/1/a_src"):
        checkpoint.load_best(str(tmp_path), model)
    torch.save(model.state_dict(), str(tmp_path / "best.ckpt"))
    with pytest.raises(ValueError, match="JAX npz layout"):
        checkpoint.load_best(str(tmp_path), model)
    (tmp_path / "best.ckpt").write_text("not a checkpoint")
    with pytest.raises(ValueError, match="not an npz checkpoint"):
        checkpoint.load_best(str(tmp_path), model)


def test_predict_reproduces_test_scores(runs):
    out_p = runs[5]
    node_idx, probs, flags, thr, data = predict.predict(out_p)
    assert np.array_equal(node_idx, np.arange(data.num_nodes))
    metrics = common.load_run_metrics(out_p)
    assert thr == metrics["threshold"]
    for split in ("test", "val"):
        idx = np.load(os.path.join(out_p, f"node_idx_{split}.npy"))
        np.testing.assert_allclose(
            probs[idx], np.load(os.path.join(out_p, f"scores_{split}.npy")), atol=1e-6)
    np.testing.assert_array_equal(flags, probs >= thr)


def test_gat_has_no_switch_to_the_plain_version(runs):
    """`gat_fused_vjp: false` is refused where the model is built; true and
    auto build the same model, which on CPU tensors is forward_plain."""
    cfg_p = runs[1]
    data = train_gnn.prepare_data(cfg_p)
    for value in (False, "sometimes"):
        with pytest.raises(ValueError, match="gat_fused_vjp"):
            build_model("gat", data.num_features, dict(cfg_p, gat_fused_vjp=value))
    data, g = train_gnn.build_graph_ops(cfg_p, data, torch.device("cpu"))
    x = torch.from_numpy(data.x)
    outs = []
    for value in (True, "auto"):
        model = build_model("gat", data.num_features, dict(cfg_p, gat_fused_vjp=value),
                            generator=torch.Generator().manual_seed(0)).eval()
        assert not hasattr(model, "fused")
        with torch.no_grad():
            outs.append(model(x, g))
            assert torch.equal(outs[-1], model.forward_plain(x, g))
    assert torch.equal(outs[0], outs[1])


def test_predict_on_sage_resbn_run(tmp_path, runs):
    """best.ckpt is written for every arch: predict scores a SAGE-ResBN run
    (BatchNorm buffers restored) as the trainer scored it."""
    cfg = dict(runs[1], arch="sage_resbn", run_name="sage_pred", layers=3,
               symmetrize_edges=True, use_time_scalar=False, time_embed_dim=2,
               time_embed_type="sin", max_timestep=16, precision_target=0.0,
               output_root=str(tmp_path))
    train_gnn.main(cfg)
    out = os.path.join(str(tmp_path), "gnn", "sage_pred")
    _, probs, _, _, _ = predict.predict(out, device="cpu")
    idx = np.load(os.path.join(out, "node_idx_test.npy"))
    np.testing.assert_allclose(
        probs[idx], np.load(os.path.join(out, "scores_test.npy")), atol=1e-6)


def test_resume_and_unported_archs_raise(runs, tmp_path):
    cfg_p = dict(runs[1], output_root=str(tmp_path))
    # resume is ported (tests/test_torch_port_resume_hubs.py); profiling is not
    with pytest.raises(NotImplementedError, match="profile_dir"):
        train_gnn.main(dict(cfg_p, profile_dir=str(tmp_path / "trace")))
    # every arch of the JAX package is ported (gcn and sage:
    # tests/test_torch_port_archs.py); an unknown one is refused
    with pytest.raises(ValueError, match="Unknown arch"):
        train_gnn.main(dict(cfg_p, arch="gin"))
    for value in (False, "sometimes"):
        with pytest.raises(ValueError, match="gat_fused_vjp"):
            train_gnn.main(dict(cfg_p, gat_fused_vjp=value))
