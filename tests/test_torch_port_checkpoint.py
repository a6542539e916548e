"""Port parity for best.ckpt, the JAX package's flat npz layout: the
port's params_to_jax inverts params_from_jax for every arch, key for key
against the JAX model's own pytrees; and on SAGE-ResBN runs (BatchNorm
state, an identity and a linear residual projection, a learned time
embedding) the JAX tools read a port run and the port reads a JAX run.

Tolerances: parameters bit for bit (a copy); predict of one
implementation against the other on the same run dir atol 1e-4 (the same
weights, two implementations of the forward)."""
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
from elliptic_gnn_tpu_torch.models import build_model
from elliptic_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from elliptic_gnn_tpu_torch.train import checkpoint, predict, train_gnn
from tests.port_native_pin import same_native
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

RESBN_CFG = {
    "run_name": "resbn_ckpt", "seed": 0, "device": "cpu", "arch": "sage_resbn",
    "hidden_dim": 16, "layers": 3, "dropout": 0.0, "lr": 0.01,
    "weight_decay": 1e-4, "grad_clip": 1.0, "max_epochs": 2, "patience": 60,
    "class_weight_pos": "auto", "amp": False, "use_val_for_thresholds": True,
    "precision_target": 0.0, "topk": 20, "symmetrize_edges": True,
    "use_time_scalar": False, "train_window_k": 10, "calibrate_temperature": False,
    # eff_in = F + 2 != 16: layer 0's residual is a projection, layer 1's
    # the identity (None in the JAX params)
    "time_embed_dim": 2, "time_embed_type": "learned", "max_timestep": 16,
}
ARCH_CFGS = {
    "gcn": {"hidden_dim": 16, "layers": 3},
    "sage": {"hidden_dim": 16, "layers": 2},
    "gat": {"hidden_dim": 16, "layers": 3, "heads": 4},
    "sage_resbn": {"hidden_dim": 16, "layers": 3, "time_embed_dim": 2,
                   "time_embed_type": "learned", "max_timestep": 16},
    "sage_bn": {"hidden_dim": 16, "layers": 3, "residual": False},
    "sage_res": {"hidden_dim": 12, "layers": 4, "use_bn": False},
}


@pytest.fixture(autouse=True, scope="module")
def _same_native():
    same_native()


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", sorted(ARCH_CFGS))
def test_params_to_jax_inverts_params_from_jax(arch):
    """JAX init -> params_from_jax -> params_to_jax gives the JAX pytrees
    back: the same flat keys as the JAX package's checkpoint writes, the
    same shapes and dtypes, the same bits."""
    cfg = dict(ARCH_CFGS[arch], dropout=0.0)
    params, state = jax_build_model(arch, 10, cfg).init(jax.random.key(3))
    model = params_from_jax(_to_np(params), _to_np(state), build_model(arch, 10, cfg))
    got_p, got_s = params_to_jax(model)
    want = jax_checkpoint._flatten({"params": params, "state": state})
    got = checkpoint.flatten({"params": got_p, "state": got_s})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def resbn_runs(tmp_path_factory):
    """A JAX and a port SAGE-ResBN run of RESBN_CFG on one processed graph;
    returns (cfg, JAX run dir, port run dir)."""
    root = tmp_path_factory.mktemp("resbn")
    split = {"seed": 0, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
             "synthetic": True, "synthetic_nodes": 1500,
             "processed_dir": str(root / "processed"), "data_dir": str(root / "raw")}
    jax_build_graph.main(split)
    cfg = dict(RESBN_CFG, processed_dir=split["processed_dir"])
    jax_train.main(dict(cfg, output_root=str(root / "jax")))
    train_gnn.main(dict(cfg, output_root=str(root / "port")))
    return (cfg, str(root / "jax" / "gnn" / cfg["run_name"]),
            str(root / "port" / "gnn" / cfg["run_name"]))


def test_jax_tools_read_a_port_sage_resbn_run(resbn_runs):
    """The JAX checkpoint.load_best reads the port's best.ckpt into the JAX
    model's templates (BN state and count, res_projs with None, time_emb),
    equal to params_to_jax of the port model loaded from it; and the JAX
    predict scores the port run as the port's predict does."""
    cfg, _, out_p = resbn_runs
    data = jax_train.prepare_data(cfg)
    p0, s0 = jax_build_model("sage_resbn", data.num_features, cfg).init(jax.random.key(1))
    params, state = jax_checkpoint.load_best(out_p, p0, s0)
    assert params["res_projs"][1] is None and params["res_projs"][0] is not None
    model = checkpoint.load_best(out_p, build_model("sage_resbn", data.num_features, cfg))
    want_p, want_s = params_to_jax(model)
    want = checkpoint.flatten({"params": want_p, "state": want_s})
    got = checkpoint.flatten({"params": _to_np(params), "state": _to_np(state)})
    assert sorted(got) == sorted(want)
    assert "state/bns/1/count" in got and got["state/bns/1/count"].shape == ()
    assert float(got["state/bns/1/count"]) > 0  # the BN buffers were trained
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    node_j, probs_j, _, thr_j, _ = jax_predict.predict(out_p)
    node_p, probs_p, _, thr_p, _ = predict.predict(out_p, device="cpu")
    np.testing.assert_array_equal(node_j, node_p)
    assert thr_j == thr_p and probs_p.std() > 1e-3
    np.testing.assert_allclose(probs_j, probs_p, atol=1e-4)


def test_port_predict_scores_a_jax_sage_resbn_run(resbn_runs):
    """The port's predict on the JAX run dir gives the JAX predict's
    probabilities, and scores_test.npy of the JAX trainer."""
    _, out_j, _ = resbn_runs
    node_j, probs_j, _, thr_j, _ = jax_predict.predict(out_j)
    node_p, probs_p, _, thr_p, _ = predict.predict(out_j, device="cpu")
    np.testing.assert_array_equal(node_p, node_j)
    assert thr_p == thr_j and probs_p.std() > 1e-3
    np.testing.assert_allclose(probs_p, probs_j, atol=1e-4)
    idx = np.load(os.path.join(out_j, "node_idx_test.npy"))
    np.testing.assert_allclose(probs_p[idx], np.load(os.path.join(out_j, "scores_test.npy")),
                               atol=1e-4)


def test_save_best_writes_the_jax_keys(tmp_path):
    """save_best of a SAGE-ResBN model: the npz holds exactly the JAX keys,
    dense weights as [d_in, d_out], the BN count 0-d; load_best restores
    every parameter and buffer bit for bit."""
    cfg = dict(ARCH_CFGS["sage_resbn"], dropout=0.0)
    model = build_model("sage_resbn", 10, cfg, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for bn in model.bns:
            bn.mean.uniform_(-1, 1)
            bn.count.fill_(7.0)
    checkpoint.save_best(str(tmp_path), model)
    assert os.listdir(str(tmp_path)) == ["best.ckpt"]
    with np.load(str(tmp_path / "best.ckpt")) as z:
        files = {k: z[k] for k in z.files}
    assert files["params/layers/0/w_l"].shape == (12, 16)
    assert files["params/res_projs/0/w"].shape == (12, 16)
    assert not any(k.startswith("params/res_projs/1") for k in files)
    assert files["state/bns/0/count"].shape == () and float(files["state/bns/0/count"]) == 7.0
    assert files["params/time_emb"].shape == (16, 2)
    fresh = checkpoint.load_best(str(tmp_path), build_model("sage_resbn", 10, cfg))
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
