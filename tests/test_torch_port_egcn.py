"""EvolveGCN-O (arch egcn_o) on the CPU: the port's model against the plain
reference tests/egcn_reference.py on seeded weights (6 snapshots, ~300
nodes, widths 16 and 12): logits, loss and every parameter's gradient; the
chain's hand-written backward through time (kernels/egcn_evolve.py, the
step functions' plain twins, as the card runs the kernels), the card's
choice between the persistent chain and the step kernels, and the grouped
row product against autograd of their plain forms; two epochs of the K
loop through train_gnn against the serial loop; and the clear errors of
the paths that refuse the model (ELL, mini_batch, a mesh).

Tolerances: the model against the reference rtol 1e-4, atol 1e-5: f32
sums in another order (a sparse aggregation against a dense product per
snapshot, the rows' product by snapshot) through six dependent GRU steps
and two layers; the hand-written backward against autograd rtol 1e-4, atol
1e-6 (the same products, summed in another order over the steps); the K
loop against the serial loop 1e-6 (one epoch body, the same ops)."""
import csv
import os
import sys

import numpy as np
import pytest
import torch

from elliptic_gnn_tpu_torch.graph import build_graph, make_temporal_masks
from elliptic_gnn_tpu_torch.graph.synthetic import generate
from elliptic_gnn_tpu_torch.kernels import egcn_evolve
from elliptic_gnn_tpu_torch.models.egcn import grouped_rows_mm
from elliptic_gnn_tpu_torch.train import train_gnn
from tests import egcn_reference as ref

T, N, F_IN = 6, 300, 10
CFG = {"arch": "egcn_o", "hidden_dim": 16, "cls_feats": 12, "layers": 2, "max_timestep": T,
       "dropout": 0.0, "amp": False, "lr": 0.01, "weight_decay": 0.0, "grad_clip": 1.0,
       "class_weight_pos": "auto", "symmetrize_edges": False, "use_time_scalar": False,
       "aggregation": "auto", "device": "cpu"}
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
BPTT_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _graph():
    data = generate(num_nodes=N, num_features=F_IN, num_timesteps=T, seed=5)
    return make_temporal_masks(data, t_train_end=4, t_val_end=5)


def _seeded(model, seed=3):
    """Seeded weights of moderate size into `model`; {name: tensor}."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.3 if p.dim() > 1 else 0.05))
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def test_model_matches_reference():
    data0 = _graph()
    data, model, gops, _, loss_fn = train_gnn.build_train_state(
        dict(CFG), data0, 0, torch.device("cpu"))
    weights = _seeded(model)
    assert list(weights) == ref.param_names(2)
    x = torch.from_numpy(data.x)
    t = torch.from_numpy(data.timestep.astype(np.int32))
    y = torch.from_numpy(np.maximum(data.y, 0).astype(np.int64))
    mask = torch.from_numpy(data.train_mask.astype(np.float32))
    logits = model(x, gops, t)
    loss = loss_fn(model, logits, y, None, mask)
    loss.backward()

    P = {k: v.clone().requires_grad_() for k, v in weights.items()}
    want = ref.forward(P, torch.from_numpy(data0.x), data0.timestep, data0.edge_index, 2, T)
    rows = torch.as_tensor(data.orig_index)  # row i of the port holds node orig_index[i]
    torch.testing.assert_close(logits.detach(), want.detach()[rows], **MODEL_TOL)
    y0 = torch.from_numpy(np.maximum(data0.y, 0).astype(np.int64))
    train0 = data0.train_mask
    pos, neg = int((data0.y[train0] == 1).sum()), int((data0.y[train0] == 0).sum())
    cw = torch.tensor([(pos + neg) / (2.0 * neg), (pos + neg) / (2.0 * pos)])
    ce = -torch.log_softmax(want, 1).gather(1, y0[:, None])[:, 0] * cw[y0]
    m = torch.from_numpy(train0.astype(np.float32))
    want_loss = (ce * m).sum() / m.sum()
    torch.testing.assert_close(loss.detach(), want_loss.detach(), **MODEL_TOL)
    grads = torch.autograd.grad(want_loss, list(P.values()))
    for (name, p), g in zip(model.named_parameters(), grads):
        assert float(g.abs().max()) > 0, name
        torch.testing.assert_close(p.grad, g, **MODEL_TOL, msg=name)


@pytest.mark.parametrize("d,c,steps", [(9, 7, 5), (12, 36, 3)])
def test_hand_written_backward_through_time(d, c, steps):
    gen = torch.Generator().manual_seed(1)

    def draw(shape, s):
        return (torch.randn(shape, generator=gen) * s).requires_grad_()

    p = {k: draw((d, c), 0.5) if k in ("q0", "b_u", "b_r", "b_h") else draw((d, d), 0.4)
         for k in egcn_evolve.PARAMS}
    ct = torch.randn((steps, d, c), generator=gen)
    got = egcn_evolve.evolve(p, steps)
    want = egcn_evolve.evolve_plain(p, steps)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    g_got = torch.autograd.grad(got, list(p.values()), ct)
    g_want = torch.autograd.grad(want, list(p.values()), ct)
    for k, a, b in zip(p, g_got, g_want):
        torch.testing.assert_close(a, b, **BPTT_TOL, msg=k)
    with torch.no_grad():  # the forward alone keeps nothing
        torch.testing.assert_close(egcn_evolve.evolve(p, steps), want.detach(), rtol=0, atol=0)


# the shapes (d, c) the card tests run the chain at (tests/test_torch_port_cuda.py
# EGCN_CHAIN_SHAPES and the model test's 12 -> 32 -> 32), and shapes past the
# persistent chain's limit
CARD_CHAIN_SHAPES = [(166, 256), (256, 256), (40, 36), (12, 36), (12, 32), (32, 32)]
PAST_THE_LIMIT = [(257, 256), (300, 256), (300, 32), (512, 64)]


def test_chain_choice_is_by_shape():
    """The card's choice between one persistent launch a pass and a launch a
    step (egcn_evolve.persistent) by (d, c): every shape the card tests run
    up to CHAIN_MAX_D takes the persistent chain, the step kernels only past
    it. (On the CPU the chain runs the step functions' plain twins at any
    shape: test_hand_written_backward_through_time.)"""
    limit = egcn_evolve.CHAIN_MAX_D
    assert all(egcn_evolve.persistent(d, c) for d, c in CARD_CHAIN_SHAPES)
    assert egcn_evolve.persistent(limit, 256) and egcn_evolve.persistent(1, 4)
    assert not any(egcn_evolve.persistent(d, c) for d, c in PAST_THE_LIMIT)
    assert not egcn_evolve.persistent(limit + 1, 4)
    assert not egcn_evolve.persistent(12, 34)  # c not a multiple of 4: no kernel takes it


def test_grouped_rows_mm_with_an_empty_snapshot():
    gen = torch.Generator().manual_seed(2)
    h = torch.randn((11, 4), generator=gen, requires_grad=True)
    qs = torch.randn((3, 4, 5), generator=gen, requires_grad=True)
    bounds = [(0, 5), (5, 5), (5, 11)]
    out = grouped_rows_mm(h, qs, bounds)
    want = torch.cat([h[a:b] @ qs[t] for t, (a, b) in enumerate(bounds)])
    torch.testing.assert_close(out, want)
    ct = torch.randn((11, 5), generator=gen)
    for a, b in zip(torch.autograd.grad(out, [h, qs], ct), torch.autograd.grad(want, [h, qs], ct)):
        torch.testing.assert_close(a, b)


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("egcn")
    cfg = {"seed": 0, "t_train_end": 4, "t_val_end": 5, "t_max": T, "synthetic": True,
           "synthetic_nodes": N, "synthetic_features": F_IN,
           "processed_dir": str(root / "processed"), "data_dir": str(root / "raw")}
    build_graph.main(cfg)
    return cfg["processed_dir"]


def _run_cfg(processed, out, **kw):
    return dict(CFG, run_name="egcn", seed=0, processed_dir=processed, output_root=str(out),
                max_epochs=2, patience=5, use_val_for_thresholds=True, precision_target=0.0,
                topk=10, calibrate_temperature=False, **kw)


def _losses(cfg):
    path = os.path.join(cfg["output_root"], "gnn", cfg["run_name"], "training_log.csv")
    with open(path) as fh:
        return np.array([float(r["train_loss"]) for r in csv.DictReader(fh)])


def test_k_loop_matches_serial(processed, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # CSV-only logger
    runs = {}
    for k in (2, 1):
        cfg = _run_cfg(processed, tmp_path / f"k{k}", epochs_per_sync=k)
        metrics = train_gnn.main(cfg)
        runs[k] = (_losses(cfg), metrics)
    (k_loss, k_m), (s_loss, s_m) = runs[2], runs[1]
    assert k_loss.shape == (2,) and np.all(np.isfinite(k_loss))
    np.testing.assert_allclose(k_loss, s_loss, rtol=1e-6, atol=1e-6)
    assert abs(k_m["best_val_pr_auc"] - s_m["best_val_pr_auc"]) <= 1e-6
    assert k_m["epochs_per_sync"] == 2 and s_m["epochs_per_sync"] == 1


@pytest.mark.parametrize("over,match", [
    ({"aggregation": "ell"}, "aggregation: ell"),
    ({"mini_batch": True}, "mini_batch"),
    ({"mesh_devices": 2}, "one device"),
    ({"aggregation": "shard_map"}, "one device"),
])
def test_refused_paths(processed, tmp_path, monkeypatch, over, match):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ValueError, match=match):
        train_gnn.main(_run_cfg(processed, tmp_path, **over))


def test_mesh_rank_is_refused(processed, tmp_path):
    """train_rank, the entry of a mesh's ranks (also called alone for a mesh
    of one), refuses the model before it starts a process group."""
    with pytest.raises(ValueError, match="one device"):
        train_gnn.train_rank(_run_cfg(processed, tmp_path, aggregation="bsda"))


def test_edges_across_timesteps_are_refused():
    data = _graph()
    ei = data.edge_index.copy()
    first = np.flatnonzero(data.timestep == 1)[0]
    last = np.flatnonzero(data.timestep == T)[0]
    ei[:, 0] = (first, last)
    with pytest.raises(ValueError, match="within one timestep"):
        train_gnn.build_graph_ops(dict(CFG), data.replace(edge_index=ei), torch.device("cpu"))
