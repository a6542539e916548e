"""Port parity of the GNN explainer and of the models on an ELL graph.

  - models.prepare_graph_ops of the port against the JAX one (sage, gcn,
    gat): the same ELL arrays;
  - each arch on those ELL ops against the JAX model on the same ops and
    parameters (eval logits, two layers, rtol 1e-5, atol 1e-5: a few f32
    sums in another order; `amp` on, which the ELL path ignores in both);
  - explain_node on a port run dir (trained by the port on the CPU, 3
    epochs) against the JAX explainer's run_gnn on the same run dir, 20
    steps, for a sage_resbn and a GAT run: the same node and predicted
    class, and the edge masks keyed by (src, dst) (the JAX tool reports
    every non-self-loop edge when its top_k covers them all) and the
    feature masks within atol 1e-4 (20 Adam steps of lr 0.05 in f32: the
    two optimizers round differently, and a step moves a mask logit by
    at most 0.05);
  - run_gnn's two artifacts, and `device: cuda` raising without a GPU."""
import collections
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.analysis import explain as jax_explain
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu.models import prepare_graph_ops as jax_prepare_graph_ops
from elliptic_gnn_tpu_torch.analysis import explain
from elliptic_gnn_tpu_torch.graph import build_graph
from elliptic_gnn_tpu_torch.models import build_model, prepare_graph_ops
from elliptic_gnn_tpu_torch.models.convert import params_from_jax
from elliptic_gnn_tpu_torch.train import train_gnn
from tests.port_native_pin import same_native
from tests.test_torch_port_tables import port_graph

STEPS = 20
MASK_ATOL = 1e-4
RUN_CFGS = {
    "sage_resbn": {"arch": "sage_resbn", "hidden_dim": 16, "layers": 2,
                   "time_embed_dim": 2, "time_embed_type": "sin", "max_timestep": 16},
    "gat": {"arch": "gat", "hidden_dim": 16, "heads": 2, "layers": 2},
}


@pytest.fixture(autouse=True, scope="module")
def _same_native():
    same_native()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("explain")
    processed = str(root / "processed")
    build_graph.main({"seed": 3, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
                      "synthetic": True, "synthetic_nodes": 2500,
                      "processed_dir": processed, "data_dir": str(root / "raw")})
    out = {}
    for name, arch_cfg in RUN_CFGS.items():
        cfg = {"run_name": name, "seed": 3, "device": "cpu", "processed_dir": processed,
               "output_root": str(root / "outputs"), "dropout": 0.0, "lr": 0.01,
               "weight_decay": 1e-4, "max_epochs": 3, "patience": 3, "topk": 20,
               "calibrate_temperature": True, **arch_cfg}
        train_gnn.main(cfg)
        out[name] = os.path.join(cfg["output_root"], "gnn", name)
    return out


def _copy(run_dir, tmp_path, tag):
    dst = str(tmp_path / tag)
    shutil.copytree(run_dir, dst)
    return dst


@pytest.mark.parametrize("kind", ["sage", "gcn", "gat"])
def test_prepare_graph_ops_matches_jax(kind):
    ei, _ = port_graph(300, 3, 1.5, seed=7, n_far=20)
    gj = jax_prepare_graph_ops(ei, 300, kind)
    gp = prepare_graph_ops(ei, 300, kind)
    assert gp.widths == gj.widths and gp.n_zero_deg == gj.n_zero_deg
    np.testing.assert_array_equal(gp.inv_perm.numpy(), np.asarray(gj.inv_perm))
    for name in ("nbrs", "weights", "rows", "row_scale"):
        for a, b in zip(getattr(gp, name), getattr(gj, name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("arch", ["sage_resbn", "gcn", "sage", "gat"])
def test_model_on_ell_matches_jax(arch):
    n, f_in = 400, 12
    ei, block_ids = port_graph(n, 3, 1.5, seed=11, n_far=30)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, f_in)).astype(np.float32)
    t = (block_ids * 3 + 1).astype(np.int32)
    cfg = {"hidden_dim": 16, "layers": 2, "heads": 2, "dropout": 0.0, "amp": True,
           "time_embed_dim": 2, "time_embed_type": "sin", "max_timestep": 16}
    kind = {"gcn": "gcn", "gat": "gat"}.get(arch, "sage")
    mj = jax_build_model(arch, f_in, cfg)
    params, state = mj.init(jax.random.key(5))
    gj = jax_prepare_graph_ops(ei, n, kind)
    want, _ = jax.jit(lambda p, s: mj.apply(p, s, x, gj, t if mj.uses_time_embed else None,
                                            training=False))(params, state)
    mp = build_model(arch, f_in, cfg)
    params_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state), mp)
    with torch.no_grad():
        got = mp.eval()(torch.from_numpy(x), prepare_graph_ops(ei, n, kind),
                        torch.from_numpy(t) if mp.uses_time_embed else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _by_edge(pairs, values):
    out = collections.defaultdict(list)
    for (s, d), v in zip(pairs, values):
        out[(int(s), int(d))].append(float(v))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("arch", list(RUN_CFGS))
def test_explain_node_matches_jax(runs, tmp_path, arch):
    jax_dir = _copy(runs[arch], tmp_path, "jax")
    jax_explain.run_gnn(jax_dir, steps=STEPS, top_k=10 ** 9)
    with open(os.path.join(jax_dir, "gnn_explainer_importance.json")) as f:
        want = json.load(f)

    ex = explain.explain_node(runs[arch], steps=STEPS, device="cpu")
    assert (ex.node_idx, ex.picked, ex.predicted_class) == (
        want["node_idx"], want["picked"], want["predicted_class"])
    assert np.isfinite(ex.loss)
    no_loop = ex.edges[:, 0] != ex.edges[:, 1]
    got_e = _by_edge(ex.edges[no_loop], ex.edge_mask.numpy()[no_loop])
    want_e = _by_edge([(e["src"], e["dst"]) for e in want["top_edges"]],
                      [e["importance"] for e in want["top_edges"]])
    assert got_e.keys() == want_e.keys() and got_e
    for k in want_e:
        np.testing.assert_allclose(got_e[k], want_e[k], atol=MASK_ATOL, rtol=0, err_msg=k)
    got_f = ex.feat_mask.numpy()
    want_f = np.zeros_like(got_f)
    for e in want["top_features"]:
        want_f[int(e["feature"][1:])] = e["importance"]
    assert len(want["top_features"]) == got_f.size
    np.testing.assert_allclose(got_f, want_f, atol=MASK_ATOL, rtol=0)
    if arch == "gat":
        # validity-only weights: every edge mask saw the same L1 + entropy
        # gradient, so the masks stay equal to one another
        assert np.ptp(ex.edge_mask.numpy()) < 1e-6


def test_run_gnn_writes_the_jax_artifacts(runs, tmp_path):
    port_dir = _copy(runs["sage_resbn"], tmp_path, "port")
    jax_dir = _copy(runs["sage_resbn"], tmp_path, "jax")
    ex = explain.run_gnn(port_dir, steps=STEPS, device="cpu")
    jax_explain.run_gnn(jax_dir, steps=STEPS)
    docs = []
    for d in (port_dir, jax_dir):
        with open(os.path.join(d, "gnn_explainer_importance.json")) as f:
            docs.append(json.load(f))
        png = os.path.join(d, f"gnn_explainer_node_{ex.node_idx}.png")
        assert os.path.getsize(png) > 0
    got, want = docs
    assert got.keys() == want.keys()
    for k in ("node_idx", "picked", "predicted_class"):
        assert got[k] == want[k], k
    assert len(got["top_edges"]) == len(want["top_edges"])
    assert len(got["top_features"]) == len(want["top_features"]) == 20


def test_explain_on_cuda_raises_without_gpu(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        explain.explain_node(runs["gat"], steps=1, device="cuda")
