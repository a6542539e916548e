"""Port parity for the GCN and SAGE archs: the torch modules with the JAX
models' init parameters carried across by params_from_jax, against the JAX
models on the same tables and numpy-seeded inputs (eval logits, and
parameter gradients of the masked weighted-CE loss at dropout 0); then the
torch trainer's train_gnn.main on a tiny synthetic processed graph (device
cpu, 3 epochs) against the JAX trainer on the same config, epoch by epoch.

The JAX side aggregates through the Pallas kernel (interpret mode) with
amp, through its XLA path without, as tests/test_torch_port_model.py.
Tolerances: f32 logits rtol 1e-5, atol 1e-5, f32 gradients rtol 1e-4, atol
1e-5 (a few layers of f32 sums in another order); amp (bf16 aggregation
operands and results) rtol 5e-2, atol 5e-2; the trainer as
tests/test_torch_port_train.py: loss rtol 1e-4, PR-AUC and test metrics
atol 2e-3, test scores atol 2e-3."""
import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.graph import build_graph as jax_build_graph
from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu.models.losses import make_loss_fn as jax_make_loss_fn
from elliptic_gnn_tpu.train import train_gnn as jax_train
from elliptic_gnn_tpu_torch.kernels import bsda as port_bsda
from elliptic_gnn_tpu_torch.models import MODEL_GRAPH_KIND, build_model
from elliptic_gnn_tpu_torch.models.convert import params_from_jax
from elliptic_gnn_tpu_torch.models.losses import make_loss_fn
from elliptic_gnn_tpu_torch.models.modules import GCN, SAGE
from elliptic_gnn_tpu_torch.train import predict, train_gnn
from tests.jax_reference import jit_as_eager
from tests.port_native_pin import same_native
from tests.test_torch_port_tables import port_graph
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

N, F_IN = 900, 20
F32 = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)
AMP = dict(rtol=5e-2, atol=5e-2)
ARCHS = ["gcn", "sage"]
# the JAX parameter names of one layer, and where the port keeps each
# (weights transposed: nn.Linear holds [d_out, d_in])
LAYER_PARAMS = {
    "gcn": {"w": lambda l: l.lin.weight.grad.T, "b": lambda l: l.bias.grad},
    "sage": {"w_l": lambda l: l.lin_l.weight.grad.T, "b_l": lambda l: l.lin_l.bias.grad,
             "w_r": lambda l: l.lin_r.weight.grad.T},
}


@pytest.fixture(autouse=True, scope="module")
def _same_native():
    same_native()


def _setup(arch, amp, layers=3):
    ei, _ = port_graph(N, 4, 1.5, seed=43, n_far=50)
    rng = np.random.default_rng(43)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    y = (rng.random(N) < 0.2).astype(np.int32)
    mask = (rng.random(N) < 0.5).astype(np.float32)
    kind = MODEL_GRAPH_KIND[arch]
    gj = jax_bsda.build_bsda_for_kind(ei, N, kind, depth=3, a_dtype="int8")
    if amp:
        gj = dataclasses.replace(
            gj, use_pallas_kernel=True,
            transpose=dataclasses.replace(gj.transpose, use_pallas_kernel=True))
    gp = port_bsda.build_bsda_for_kind(ei, N, kind, depth=3, a_dtype="int8")
    assert gp.residual is not None and gp.transpose is not None
    cfg = {"hidden_dim": 16, "layers": layers, "dropout": 0.0, "amp": amp,
           "weight_decay": 0.0, "lr": 1e-3}
    mj = jax_build_model(arch, F_IN, cfg)
    params, state = mj.init(jax.random.key(3))
    mp = build_model(arch, F_IN, cfg)
    assert isinstance(mp, {"gcn": GCN, "sage": SAGE}[arch]) and not mp.uses_time_embed
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    params_from_jax(to_np(params), to_np(state), mp)
    return dict(x=x, y=y, mask=mask, gj=gj, gp=gp, mj=mj, mp=mp, params=params,
                state=state, cfg=cfg)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("amp", [False, True])
def test_eval_logits_match(arch, amp):
    s = _setup(arch, amp)
    lj = jit_as_eager(lambda p: s["mj"].apply(p, s["state"], jnp.asarray(s["x"]), s["gj"],
                                              training=False)[0])(s["params"])
    s["mp"].eval()
    with torch.no_grad():
        lp = s["mp"](torch.from_numpy(s["x"]), s["gp"])
    assert lp.shape == (N, 2)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **(AMP if amp else F32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("amp", [False, True])
def test_param_grads_match(arch, amp):
    s = _setup(arch, amp)
    cw = np.array([0.6, 2.5], np.float32)
    loss_j = jax_make_loss_fn(s["cfg"], cw, 1, 10)
    loss_p = make_loss_fn(s["cfg"], cw, 1, 10)
    x, y, m = jnp.asarray(s["x"]), jnp.asarray(s["y"]), jnp.asarray(s["mask"])

    def lf(p):
        logits, _ = s["mj"].apply(p, s["state"], x, s["gj"], training=True,
                                  rng=jax.random.key(0))
        return loss_j(p, logits, y, None, m)

    lval_j, grads = jit_as_eager(jax.value_and_grad(lf))(s["params"])
    mp = s["mp"].train()
    logits = mp(torch.from_numpy(s["x"]), s["gp"])
    lval_p = loss_p(mp, logits, torch.from_numpy(s["y"]), None,
                    torch.from_numpy(s["mask"]))
    lval_p.backward()
    np.testing.assert_allclose(float(lval_p.detach()), float(lval_j),
                               **(AMP if amp else F32))
    assert len(mp.layers) == len(grads["layers"]) == 3
    for layer, gl in zip(mp.layers, grads["layers"]):
        assert sorted(gl) == sorted(LAYER_PARAMS[arch])
        for name, grad_of in LAYER_PARAMS[arch].items():
            np.testing.assert_allclose(grad_of(layer).numpy(), np.asarray(gl[name]),
                                       err_msg=name, **(AMP if amp else F32_GRAD))


@pytest.mark.parametrize("arch", ARCHS)
def test_dropout_and_params_from_jax_checks(arch):
    """Training mode drops hidden activations with the generator's masks
    (same seed, same logits; eval is untouched); a pytree of another arch
    or depth is refused."""
    s = _setup(arch, False)
    mp = build_model(arch, F_IN, dict(s["cfg"], dropout=0.5),
                     generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(s["x"])
    mp.train()
    with torch.no_grad():
        a = mp(x, s["gp"], generator=torch.Generator().manual_seed(5))
        b = mp(x, s["gp"], generator=torch.Generator().manual_seed(5))
        c = mp(x, s["gp"], generator=torch.Generator().manual_seed(6))
        mp.eval()
        d = mp(x, s["gp"], generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    other = "sage" if arch == "gcn" else "gcn"
    with pytest.raises(KeyError):
        params_from_jax(to_np(_setup(other, False)["params"]), {}, mp)
    with pytest.raises(ValueError, match="layer count"):
        params_from_jax(to_np(_setup(arch, False, layers=2)["params"]), {}, mp)
    with pytest.raises(ValueError, match="layers must be >= 2"):
        build_model(arch, F_IN, dict(s["cfg"], layers=1))


# ---------------- the trainer ----------------

@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("archs")
    cfg = {"seed": 0, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
           "synthetic": True, "synthetic_nodes": 2500,
           "processed_dir": str(root / "processed"), "data_dir": str(root / "raw")}
    jax_build_graph.main(cfg)
    return cfg["processed_dir"]


def _cfg(arch, processed_dir, out):
    """configs/gcn.yaml and configs/sage.yaml at a small width, f32."""
    return {
        "run_name": f"{arch}_parity", "seed": 0, "processed_dir": processed_dir,
        "output_root": str(out), "device": "cpu", "arch": arch, "hidden_dim": 16,
        "layers": 3 if arch == "gcn" else 2, "dropout": 0.0, "lr": 0.01,
        "weight_decay": 1e-4, "grad_clip": 1.0, "max_epochs": 3, "patience": 50,
        "class_weight_pos": "auto", "amp": False, "use_val_for_thresholds": True,
        "precision_target": 0.75, "topk": 20, "symmetrize_edges": False,
        "use_time_scalar": True, "train_window_k": 10,
        # as tests/test_torch_port_gat_train.py: keep the scores informative
        "calibrate_temperature": False,
    }


def _log(outdir):
    with open(os.path.join(outdir, "training_log.csv")) as f:
        rows = list(csv.DictReader(f))
    return (np.array([float(r["train_loss"]) for r in rows]),
            np.array([float(r["val_pr_auc"]) for r in rows]))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_jax_trainer(processed, tmp_path, arch):
    cfg_j = _cfg(arch, processed, tmp_path / "jax")
    cfg_p = _cfg(arch, processed, tmp_path / "port")
    m_j = jax_train.main(dict(cfg_j))
    data = jax_train.prepare_data(cfg_j)
    model = jax_build_model(arch, data.num_features, cfg_j)
    params, state = model.init(jax.random.key(cfg_j["seed"]))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    m_p = train_gnn.main(dict(cfg_p), init_params=(to_np(params), to_np(state)))

    out_j = os.path.join(cfg_j["output_root"], "gnn", cfg_j["run_name"])
    out_p = os.path.join(cfg_p["output_root"], "gnn", cfg_p["run_name"])
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

    # the tables the trainer built, and predict on the finished run dir
    _, g = train_gnn.build_graph_ops(cfg_p, train_gnn.prepare_data(cfg_p),
                                     torch.device("cpu"))
    assert g.depth == 3 and g.transpose is not None and g.a.dtype == torch.int8
    assert (g.src_scale is not None) == (arch == "gcn") and g.dst_scale is not None
    _, probs, _, _, _ = predict.predict(out_p, device="cpu")
    idx = np.load(os.path.join(out_p, "node_idx_test.npy"))
    np.testing.assert_allclose(probs[idx], scores, atol=1e-6)
