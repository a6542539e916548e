"""The halo path over real process groups: gloo ranks on the CPU, one
process each, against the JAX package.

A world of 4 ranks (started once with parallel/multihost.py::spawn_ranks,
each process one rank of the EGNN_* path; tests/torch_port_ranks.py holds
their jobs) runs:
  - sharded_bsda_spmm (sage and gcn tables through the kernel route's
    Function) and sharded_gat_attend, forward
    and gradient, held against the JAX package's shard_map at 4 virtual
    devices on the same graph (tests/torch_port_ranks.py::band_graph);
  - one sage_resbn step from the JAX model's weights (params_from_jax,
    BatchNorm on, dropout 0), its loss and gradients before Adam held
    against the single-device port step; the same in a world of 2;
  - train_gnn.main at `mesh_devices: 4` for SAGE-ResBN, GCN, SAGE and GAT
    on a 1,500-node graph: every rank stops at the same epoch, only rank 0
    writes a run dir, every arch against its single-device port run; and
    SAGE-ResBN from the JAX trainer's init (serial loop and
    `epochs_per_sync: 4`) against the JAX trainer's shard_map run at 4
    devices, the K loop against the serial one, and predict on the sharded
    run dir.
train_gnn.main with `mesh_devices: 2` on GAT starts its two ranks itself.

Both worlds (4 ranks and 2) run GAT through the packed route, the model's
route on a mesh (the GAT kernels' plain versions on CPU tensors), with the
one-sweep and the two-sweep backward: each rank's rows of the halo path's
sharded_gat_attend_packed and their gradients with respect to x_proj, a_src
and a_dst against the JAX package's sharded_gat_attend under shard_map;
each rank's rows of the GSPMD route's row_gat_attend_packed against the JAX
package's attention of the whole graph and its vjp.

The same worlds run the GSPMD row sharding (parallel/gspmd_step.py):
  - each rank's rows of kernels.spmm on its RowShardedBsda (sage and gcn
    int8 tables with transposes: the all-gather, the rectangular dense
    part and the spill; backward the transpose slice) and RowShardedEll
    (the SAGE mean ELL), forward and the gradient of sum(out * w), held
    against the JAX package's bsda_spmm / ell_spmm and jax.vjp on the whole
    graph;
  - one training step (clip and Adam) over 4 and 2 ranks from the JAX
    model's weights, against the single-device port step: SAGE-ResBN on
    the ELL encoding (loss rtol 1e-5, parameters and BatchNorm buffers
    rtol 2e-4 / atol 2e-5) and SAGE-ResBN, GCN and GAT on the BSDA tables
    (loss rtol 1e-5, rtol 2e-3 / atol 3e-4), the bounds of
    tests/test_parallel.py::test_sharded_step_matches_single_device and
    ::test_sharded_bsda_step_matches_single_device;
  - train_gnn.main at `mesh_devices: 4` with `aggregation: bsda` and `ell`
    against the single-device run, and the `auto` fallback when
    partition_bsda rejects the graph (tests/torch_port_ranks.py patches
    the trainer's name for it): the "falling back to GSPMD einsum" line,
    the metrics within 2e-3, and an explicit `shard_map` raising.

Tolerances: aggregation, attention and their gradients rtol 1e-4, atol
1e-5 (tests/test_shardmap.py); the step's loss within 1e-5 relative, each
gradient within 1e-5 of the single-device step's largest gradient entry
(the bias before a BatchNorm has a gradient of rounding noise); test and
best-val PR-AUC 2e-3 (tests/test_parallel.py); the K loop against the
serial loop 1e-6 (tests/test_parallel.py::test_epochs_per_sync_scan_composes_with_shardmap);
predict 1e-6."""
import json
import os
import pickle
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from elliptic_gnn_tpu.graph import build_graph as jax_build_graph
from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.kernels import bsda_gat as jax_bsda_gat
from elliptic_gnn_tpu.kernels import ell as jax_ell
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu.parallel import shardmap_step as jax_sm
from elliptic_gnn_tpu.parallel.mesh import NODE_AXIS, make_mesh as jax_make_mesh
from elliptic_gnn_tpu.train import train_gnn as jax_train
from elliptic_gnn_tpu_torch.parallel import multihost
from elliptic_gnn_tpu_torch.train import predict, train_gnn
from tests import torch_port_ranks as ranks
from tests.port_native_pin import same_native
from tests.torch_exp_spread import EXP_RTOL

AGG = dict(rtol=1e-4, atol=1e-5)
PR_ATOL = 2e-3
ARCHS = {
    "sage_resbn": {},
    "gcn": {"arch": "gcn", "layers": 2},
    "sage": {"arch": "sage", "layers": 2},
    "gat": {"arch": "gat", "heads": 4, "layers": 2},
}


@pytest.fixture(autouse=True, scope="module")
def _same_native():
    same_native()


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    cfg = {"seed": 4, "t_train_end": 6, "t_val_end": 8, "t_max": 10,
           "synthetic": True, "synthetic_nodes": 1500,
           "processed_dir": str(root / "processed"), "data_dir": str(root / "raw")}
    jax_build_graph.main(cfg)
    return cfg["processed_dir"]


def _cfg(processed, out, **kw):
    cfg = {"seed": 0, "processed_dir": processed, "output_root": str(out),
           "device": "cpu", "arch": "sage_resbn", "hidden_dim": 16, "layers": 3,
           "dropout": 0.0, "lr": 0.01, "weight_decay": 0.0, "max_epochs": 6,
           "patience": 6, "time_embed_dim": 2, "time_embed_type": "sin",
           "max_timestep": 10, "symmetrize_edges": True, "grad_clip": 1.0,
           "calibrate_temperature": False}
    cfg.update(kw)
    return cfg


def _step_cfg(processed, out):
    return _cfg(processed, out, run_name="step", aggregation="shard_map")


# the GSPMD steps: tag -> (arch, aggregation)
GSPMD_STEPS = {"ell": ("sage_resbn", "ell"), "sage_resbn": ("sage_resbn", "bsda"),
               "gcn": ("gcn", "bsda"), "gat": ("gat", "bsda")}


def _gspmd_step_cfg(processed, out, tag):
    """The GSPMD step's config: JAX's test rate and decay (lr 1e-3,
    weight decay 1e-4, clip 1), the arch's widths of ARCHS."""
    arch, agg = GSPMD_STEPS[tag]
    return _cfg(processed, out, run_name=f"gstep_{tag}", aggregation=agg, lr=1e-3,
                weight_decay=1e-4, **ARCHS[arch])


def _jax_init(processed, tmp_path_factory, seed, cfg=None):
    """The JAX model's init weights from `seed` as numpy pytrees, pickled
    (SAGE-ResBN of the step config, or `cfg`'s arch); returns the file's
    path."""
    cfg = cfg or _step_cfg(processed, "unused")
    data = jax_train.prepare_data(cfg)
    params, state = jax_build_model(cfg["arch"], data.num_features, cfg).init(
        jax.random.key(seed))
    path = str(tmp_path_factory.mktemp("init") / "init.pkl")
    with open(path, "wb") as fh:
        pickle.dump(jax.tree.map(np.asarray, (params, state)), fh)
    return path


@pytest.fixture(scope="module")
def init_path(processed, tmp_path_factory):
    return _jax_init(processed, tmp_path_factory, 3)


@pytest.fixture(scope="module")
def trainer_init_path(processed, tmp_path_factory):
    """The JAX trainer's own init (the config's seed, 0)."""
    return _jax_init(processed, tmp_path_factory, 0)


@pytest.fixture(scope="module")
def gspmd_inits(processed, tmp_path_factory):
    """The JAX init of each GSPMD step's arch (seed 3), by tag."""
    return {tag: _jax_init(processed, tmp_path_factory, 3,
                           _gspmd_step_cfg(processed, "unused", tag))
            for tag in GSPMD_STEPS}


def _gspmd_step_jobs(processed, out, gspmd_inits):
    return [("gspmd_step", {"cfg": _gspmd_step_cfg(processed, out, tag),
                            "init_path": gspmd_inits[tag], "tag": tag})
            for tag in GSPMD_STEPS]


@pytest.fixture(scope="module")
def world4(processed, init_path, trainer_init_path, gspmd_inits, tmp_path_factory):
    """Every job of the 4-rank world, run once; returns (root, output root)."""
    root = str(tmp_path_factory.mktemp("world4"))
    out = os.path.join(root, "out")
    jobs = [("agg", {"kind": "sage"}),
            ("agg", {"kind": "gcn"}),
            ("gat", {}),
            ("gat_packed", {}),
            ("gspmd_gat", {}),
            ("step", {"cfg": _step_cfg(processed, out), "init_path": init_path})]
    jobs += [("main", {"cfg": _cfg(processed, out, run_name=f"m4_{arch}",
                                   mesh_devices=4, **extra)})
             for arch, extra in ARCHS.items()]
    # SAGE-ResBN from the JAX trainer's init, serial loop and K = 4
    jobs += [("main", {"cfg": _cfg(processed, out, run_name=f"m4_jax_k{k}", mesh_devices=4,
                                   epochs_per_sync=k),
                       "init_path": trainer_init_path}) for k in (1, 4)]
    # the GSPMD row sharding: aggregations, steps, the trainer, the fallback
    jobs += [("gspmd_agg", {"kind": kind}) for kind in ("sage", "gcn", "ell")]
    jobs += _gspmd_step_jobs(processed, out, gspmd_inits)
    jobs += [("main", {"cfg": _cfg(processed, out, run_name=f"g4_{agg}", mesh_devices=4,
                                   aggregation=agg)}) for agg in ("bsda", "ell")]
    jobs += [("fallback", {"cfg": _cfg(processed, os.path.join(root, "fb"),
                                       run_name="fb4", mesh_devices=4)})]
    multihost.spawn_ranks(4, ranks.run_jobs, (root, jobs), "cpu")
    return root, out


def _gather(root, pattern, n=4):
    parts = [np.load(os.path.join(root, pattern.format(r=r))) for r in range(n)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0].files}


def _jax_sharded(fn, g, *arrays, n=4):
    """fn(sg_loc, *row arrays) under JAX shard_map at n virtual devices,
    with the gradient of sum(out * w) for the last argument w."""
    mesh = jax_make_mesh(n)
    sg = jax_sm.partition_bsda(jax_bsda.pad_bsda_chunks(g, n), n, use_pallas=False)
    rows = [P(NODE_AXIS, *([None] * (a.ndim - 1))) for a in arrays[:-1]]
    out_spec = P(NODE_AXIS, *([None] * (arrays[0].ndim - 1)))
    run = shard_map(partial(fn), mesh=mesh,
                    in_specs=(jax_sm.sharded_specs(sg), *rows), out_specs=out_spec,
                    check_vma=True)
    xs = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, s))
          for a, s in zip(arrays[:-1], rows)]
    w = jnp.asarray(arrays[-1])
    out = jax.jit(run)(sg, *xs)
    grads = jax.jit(jax.grad(lambda s, *q: (run(s, *q) * w).sum(),
                             argnums=tuple(range(1, len(xs) + 1))))(sg, *xs)
    return np.asarray(out), [np.asarray(gr) for gr in grads]


@pytest.mark.parametrize("kind", ["sage", "gcn"])
def test_sharded_spmm_matches_jax_shard_map(world4, kind):
    ei, n = ranks.band_graph()
    g = jax_bsda.build_bsda_for_kind(ei, n, kind, depth=3, a_dtype="int8",
                                     transpose=False)
    n_rows = -(-g.num_chunks // 4) * 4 * g.chunk
    x, w = ranks.agg_inputs(n_rows, 16)
    want, (want_grad,) = _jax_sharded(jax_sm.sharded_bsda_spmm, g, x, w)
    got = _gather(world4[0], f"agg_{kind}_r{{r}}.npz")
    np.testing.assert_allclose(got["out"], want, **AGG)
    np.testing.assert_allclose(got["grad"], want_grad, **AGG)


def test_sharded_gat_matches_jax_shard_map(world4):
    ei, n = ranks.band_graph()
    g = jax_bsda.build_bsda_for_kind(ei, n, "gat", depth=3, a_dtype="int8",
                                     transpose=False)
    n_rows = -(-g.num_chunks // 4) * 4 * g.chunk
    xp, a_s, a_d, w = ranks.gat_inputs(n_rows)
    want, (d_xp, d_src, d_dst) = _jax_sharded(jax_sm.sharded_gat_attend, g, xp, a_s, a_d, w)
    got = _gather(world4[0], "gat_r{r}.npz")
    np.testing.assert_allclose(got["out"], want, **AGG)
    # the first call, whose exps may err by EXP_RTOL relative: an output is
    # a weighted mean of rows of x_proj, and weights off by a factor within
    # 1 +- r move it by at most 2r max|x_proj|; the spill merge reweights
    # two such means once more
    np.testing.assert_allclose(got["out_first"], want, rtol=AGG["rtol"],
                               atol=4 * EXP_RTOL * np.abs(xp).max())
    for name, ref in (("d_xp", d_xp), ("d_src", d_src), ("d_dst", d_dst)):
        np.testing.assert_allclose(got[name], ref, err_msg=name, **AGG)


def _assert_gat_rows(got, want, grads, tag):
    """The packed route's rows and gradients (`tag`: the backward) against
    the JAX reference's, within AGG."""
    np.testing.assert_allclose(got[f"out_{tag}"], want, err_msg=f"out {tag}", **AGG)
    for name, ref in zip(("d_xp", "d_src", "d_dst"), grads):
        np.testing.assert_allclose(got[f"{name}_{tag}"], ref, err_msg=f"{name} {tag}", **AGG)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_packed_halo_gat_matches_jax_shard_map(world4, world2_step, n_ranks):
    """Each rank's rows of the halo path's packed GAT route, forward and
    the gradients of sum(val * w), with either backward, against the JAX
    package's sharded_gat_attend under shard_map at as many devices; the
    first call, as test_sharded_gat_matches_jax_shard_map holds it."""
    root = world4[0] if n_ranks == 4 else world2_step
    ei, n = ranks.band_graph()
    g = jax_bsda.build_bsda_for_kind(ei, n, "gat", depth=3, a_dtype="int8",
                                     transpose=False)
    n_rows = -(-g.num_chunks // n_ranks) * n_ranks * g.chunk
    xp, a_s, a_d, w = ranks.gat_inputs(n_rows)
    want, grads = _jax_sharded(jax_sm.sharded_gat_attend, g, xp, a_s, a_d, w, n=n_ranks)
    got = _gather(root, "gat_packed_r{r}.npz", n_ranks)
    np.testing.assert_allclose(got["out_first"], want, rtol=AGG["rtol"],
                               atol=4 * EXP_RTOL * np.abs(xp).max())
    for tag in ("one", "two"):
        _assert_gat_rows(got, want, grads, tag)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_packed_gspmd_gat_matches_jax(world4, world2_step, n_ranks):
    """Each rank's rows of the GSPMD route's packed GAT attention, forward
    and the gradients of sum(val * w), with either backward, against the
    JAX package's attention of the whole graph (bsda_gat_aggregate) and its
    vjp; the padded rows (edge-free) stay 0."""
    root = world4[0] if n_ranks == 4 else world2_step
    ei, n = ranks.band_graph()
    got = _gather(root, "gspmd_gat_r{r}.npz", n_ranks)
    xp, a_s, a_d, w = ranks.gat_inputs(got["out_one"].shape[0])
    g = jax_bsda.build_bsda_for_kind(ei, n, "gat", depth=3, a_dtype="int8")
    out, vjp = jax.vjp(lambda *t: jax_bsda_gat.bsda_gat_aggregate(g, *t),
                       *(jnp.asarray(v[:n]) for v in (xp, a_s, a_d)))
    grads = [np.asarray(d) for d in vjp(jnp.broadcast_to(jnp.asarray(w), out.shape))]
    for tag in ("one", "two"):
        _assert_gat_rows({k: v[:n] for k, v in got.items()}, np.asarray(out), grads, tag)
        assert not any(got[f"{k}_{tag}"][n:].any() for k in ("out", "d_xp", "d_src", "d_dst"))


def test_torch_exp_spread_within_its_tolerance():
    """tests/torch_exp_spread.py in 6 processes at once, 2 threads each as
    the ranks run: every exp call within EXP_RTOL of the float64 exp."""
    script = os.path.join(os.path.dirname(__file__), "torch_exp_spread.py")
    procs = [subprocess.Popen([sys.executable, script, str(seed)], stdout=subprocess.PIPE,
                              text=True) for seed in range(6)]
    reports = [json.loads(p.communicate()[0].strip().splitlines()[-1]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert max(max(r["calls"]) for r in reports) <= EXP_RTOL, reports


def _single_device_step(cfg, init_path):
    """The port's single-device training step of the same weights: loss and
    gradients before the clip and Adam."""
    with open(init_path, "rb") as fh:
        init_params = pickle.load(fh)
    cfg = dict(cfg, aggregation="bsda")
    data = train_gnn.prepare_data(cfg)
    data, model, gops, _, loss_fn = train_gnn.build_train_state(
        cfg, data, cfg["seed"], torch.device("cpu"), init_params)
    x = torch.from_numpy(data.x)
    t = torch.from_numpy(data.timestep.astype(np.int32))
    model.train()
    logits = model(x, gops, t)
    loss = loss_fn(model, logits, torch.from_numpy(np.maximum(data.y, 0)), None,
                   torch.from_numpy(data.train_mask.astype(np.float32)))
    loss.backward()
    return loss.item(), {k: p.grad.numpy() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def world2_step(processed, init_path, gspmd_inits, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("world2"))
    out = os.path.join(root, "out")
    multihost.spawn_ranks(2, ranks.run_jobs, (root, [
        ("gat_packed", {}), ("gspmd_gat", {}),
        ("step", {"cfg": _step_cfg(processed, out), "init_path": init_path})]
        + _gspmd_step_jobs(processed, out, gspmd_inits)), "cpu")
    return root


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_sharded_step_matches_single_device(processed, init_path, world4, world2_step,
                                            tmp_path, n_ranks):
    root = world4[0] if n_ranks == 4 else world2_step
    got = np.load(os.path.join(root, f"step_n{n_ranks}.npz"))
    loss, grads = _single_device_step(_step_cfg(processed, tmp_path), init_path)
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    assert set(grads) == set(got.files) - {"loss"}
    scale = max(float(np.abs(g).max()) for g in grads.values())
    for name, ref in grads.items():
        np.testing.assert_allclose(got[name], ref, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def _rank_metrics(root, run_name, n=4):
    out = []
    for r in range(n):
        with open(os.path.join(root, f"main_{run_name}_r{r}.json")) as fh:
            out.append(json.load(fh))
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_mesh_trainer_all_archs(processed, world4, tmp_path, arch):
    """Every arch trains at mesh_devices: 4: all ranks report the same
    epochs and metrics, only rank 0's output root holds a run dir, and the
    run agrees with the single-device port run."""
    root, out = world4
    name = f"m4_{arch}"
    per_rank = _rank_metrics(root, name)
    assert all(m == per_rank[0] for m in per_rank), per_rank
    run_dir = os.path.join(out, "rank0", "gnn", name)
    for f in ("metrics.json", "scores_test.npy", "best.ckpt", "training_log.csv",
              "config_used.yaml"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    for r in (1, 2, 3):
        assert not os.path.exists(os.path.join(out, f"rank{r}")), r
    with open(os.path.join(run_dir, "metrics.json")) as fh:
        m4 = json.load(fh)
    assert m4["mesh_devices"] == 4 and m4["epochs_run"] == per_rank[0]["epochs_run"]
    one = train_gnn.main(_cfg(processed, tmp_path, run_name="one", **ARCHS[arch]))
    for key in ("pr_auc_illicit", "best_val_pr_auc"):
        assert abs(m4[key] - one[key]) < PR_ATOL, key


def test_mesh_trainer_matches_jax_shard_map(processed, world4, tmp_path):
    """SAGE-ResBN at mesh_devices: 4 against the JAX trainer's shard_map
    run at 4 devices; epochs_per_sync 4 against the serial loop; predict
    on the sharded run dir rebuilds the single-device encoding."""
    root, out = world4
    m_j = jax_train.main(_cfg(processed, tmp_path, run_name="jax4", mesh_devices=4,
                              aggregation="shard_map"))
    with open(os.path.join(out, "rank0", "gnn", "m4_jax_k1", "metrics.json")) as fh:
        m_p = json.load(fh)
    with open(os.path.join(out, "rank0", "gnn", "m4_jax_k4", "metrics.json")) as fh:
        m_k = json.load(fh)
    for key in ("pr_auc_illicit", "best_val_pr_auc"):
        assert abs(m_p[key] - m_j[key]) < PR_ATOL, key
        assert abs(m_k[key] - m_p[key]) < 1e-6, key
    assert m_k["epochs_per_sync"] == 4 and m_k["epochs_run"] == m_p["epochs_run"]
    run_dir = os.path.join(out, "rank0", "gnn", "m4_jax_k1")
    _, probs, _, _, _ = predict.predict(run_dir, device="cpu")
    idx = np.load(os.path.join(run_dir, "node_idx_test.npy"))
    np.testing.assert_allclose(probs[idx], np.load(os.path.join(run_dir, "scores_test.npy")),
                               atol=1e-6)


def test_main_spawns_ranks_for_gat(processed, tmp_path):
    """train_gnn.main at mesh_devices: 2 starts two ranks itself and
    returns rank 0's metrics; GAT attends per shard through the packed
    route (the GAT kernels' plain versions on the CPU)."""
    m2 = train_gnn.main(_cfg(processed, tmp_path, run_name="gat2", mesh_devices=2,
                             **ARCHS["gat"]))
    one = train_gnn.main(_cfg(processed, tmp_path, run_name="gat1", **ARCHS["gat"]))
    assert m2["mesh_devices"] == 2 and m2["epochs_run"] == one["epochs_run"]
    for key in ("pr_auc_illicit", "best_val_pr_auc"):
        assert abs(m2[key] - one[key]) < PR_ATOL, key


@pytest.mark.parametrize("kind", ["sage", "gcn", "ell"])
def test_gspmd_spmm_matches_jax(world4, kind):
    """Each rank's rows of the GSPMD aggregation and of d x for
    sum(out * w), concatenated, against the JAX package's aggregation of
    the whole graph and its vjp; the padded rows (edge-free) stay 0."""
    ei, n = ranks.band_graph()
    got = _gather(world4[0], f"gspmd_{kind}_r{{r}}.npz")
    x, w = ranks.agg_inputs(got["out"].shape[0], 16)
    if kind == "ell":
        g = jax_ell.build_ell_graph(ei, n, mean=True)
        fn = lambda z: jax_ell.ell_spmm(g, z)  # noqa: E731
    else:
        g = jax_bsda.build_bsda_for_kind(ei, n, kind, depth=3, a_dtype="int8")
        fn = lambda z: jax_bsda.bsda_spmm(g, z)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(x[:n]))
    ct = np.broadcast_to(w, (n, w.size))
    np.testing.assert_allclose(got["out"][:n], np.asarray(out), **AGG)
    np.testing.assert_allclose(got["grad"][:n], np.asarray(vjp(jnp.asarray(ct))[0]), **AGG)
    assert not got["out"][n:].any() and not got["grad"][n:].any()


def _single_device_adam_step(cfg, init_path):
    """The port's single-device step of the same weights and config: the
    loss, then the state dict after the clip and one Adam step."""
    with open(init_path, "rb") as fh:
        init_params = pickle.load(fh)
    data = train_gnn.prepare_data(cfg)
    data, model, gops, opt, loss_fn = train_gnn.build_train_state(
        cfg, data, cfg["seed"], torch.device("cpu"), init_params)
    t = torch.from_numpy(data.timestep.astype(np.int32))
    model.train()
    opt.zero_grad()
    logits = model(torch.from_numpy(data.x), gops, t if model.uses_time_embed else None)
    loss = loss_fn(model, logits, torch.from_numpy(np.maximum(data.y, 0)), None,
                   torch.from_numpy(data.train_mask.astype(np.float32)))
    loss.backward()
    torch.nn.utils.clip_grad_norm_(model.parameters(), float(cfg["grad_clip"]))
    opt.step()
    return loss.item(), {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("tag", sorted(GSPMD_STEPS))
def test_gspmd_step_matches_single_device(processed, gspmd_inits, world4, world2_step,
                                          tmp_path, tag, n_ranks):
    root = world4[0] if n_ranks == 4 else world2_step
    got = np.load(os.path.join(root, f"gspmd_step_{tag}_n{n_ranks}.npz"))
    cfg = _gspmd_step_cfg(processed, tmp_path, tag)
    loss, state = _single_device_adam_step(cfg, gspmd_inits[tag])
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    assert set(state) == set(got.files) - {"loss"}
    tol = dict(rtol=2e-4, atol=2e-5) if tag == "ell" else dict(rtol=2e-3, atol=3e-4)
    for name, ref in state.items():
        if name in _pre_bn_biases(cfg):
            # zero gradient in exact arithmetic (the BatchNorm after it
            # removes any shift): Adam's first step moves it by
            # lr * g / (|g| + eps) of a rounding-noise g, which the two
            # summation orders draw apart, anywhere within lr of its start
            np.testing.assert_array_less(np.abs(got[name] - ref), cfg["lr"] * (1 + 1e-6))
            continue
        np.testing.assert_allclose(got[name], ref, err_msg=name, **tol)


def _pre_bn_biases(cfg):
    """The SAGE-ResBN hidden layers' lin_l biases, each followed by a
    BatchNorm (layers - 1 of them)."""
    if cfg["arch"] != "sage_resbn":
        return ()
    return tuple(f"layers.{i}.lin_l.bias" for i in range(cfg["layers"] - 1))


@pytest.mark.parametrize("agg", ["bsda", "ell"])
def test_gspmd_trainer_matches_single_device(processed, world4, tmp_path, agg):
    """train_gnn.main at mesh_devices: 4 with a pinned encoding takes the
    GSPMD row sharding: every rank reports the same metrics, and the run
    agrees with the single-device run of the same encoding."""
    root, out = world4
    per_rank = _rank_metrics(root, f"g4_{agg}")
    assert all(m == per_rank[0] for m in per_rank), per_rank
    with open(os.path.join(out, "rank0", "gnn", f"g4_{agg}", "metrics.json")) as fh:
        m4 = json.load(fh)
    assert m4["mesh_devices"] == 4
    one = train_gnn.main(_cfg(processed, tmp_path, run_name="one", aggregation=agg))
    for key in ("pr_auc_illicit", "best_val_pr_auc"):
        assert abs(m4[key] - one[key]) < PR_ATOL, key


def test_auto_mesh_falls_back_to_gspmd_when_not_banded(processed, world4, tmp_path):
    """Counterpart of tests/test_parallel.py::test_auto_mesh_falls_back_to_gspmd_when_not_banded:
    with partition_bsda rejecting the graph, `aggregation: auto` on 4 ranks
    says it falls back to GSPMD and matches the single-device run; an
    explicit `aggregation: shard_map` raises the rejection."""
    reports = []
    for r in range(4):
        with open(os.path.join(world4[0], f"fallback_r{r}.json")) as fh:
            reports.append(json.load(fh))
    one = train_gnn.main(_cfg(processed, tmp_path, run_name="fb1"))
    for rep in reports:
        assert rep["fell_back"], rep
        assert "non-banded rejection" in (rep["error"] or ""), rep
        for key in ("pr_auc_illicit", "best_val_pr_auc"):
            assert abs(rep[key] - one[key]) < PR_ATOL, key
