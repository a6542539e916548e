"""Port parity of the halo path's host tables and of one shard's
aggregation, in one process: kernels/bsda.py::pad_bsda_chunks and
parallel/shardmap_step.py::partition_bsda against the JAX package's
(every array exactly equal, n = 2, 4, 8, the kernel route's tables on),
shard_local_aggregate of every shard with host-assembled halos against the
JAX single-device bsda_spmm and its jax.grad, the segment ops, NullLogger,
and the trainer at `aggregation: shard_map, mesh_devices: 1` (a world of
one) against the single-device trainer, with predict rebuilding the
single-device encoding of its run dir.

The graph: 2,900 synthetic nodes (23 chunks, padded to 24), symmetrized,
BFS-renumbered, plus 600 random edges both ways between nodes at most 250
rows apart, so that depth 3 spills, every shard boundary has halo fix-ups
and the halo is two chunks.

Tolerances: the aggregation and its gradient rtol 1e-4, atol 1e-5 (JAX's
tests/test_shardmap.py: f32 sums in another order, hub-row gradients of
O(100)); segment ops 1e-6; the mesh-1 trainer against the single-device
trainer 1e-6 on the metrics (the same dense tables; the spill summed in
another order); predict 1e-6."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.graph import build_graph as jax_build_graph
from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.kernels import segment as jax_segment
from elliptic_gnn_tpu.parallel import shardmap_step as jax_sm
from elliptic_gnn_tpu_torch.kernels import bsda, segment
from elliptic_gnn_tpu_torch.parallel import shardmap_step
from elliptic_gnn_tpu_torch.train import predict, train_gnn
from elliptic_gnn_tpu_torch.utils.logger import NullLogger, RunLogger
from tests.torch_port_ranks import band_graph
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

AGG = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def graph():
    return band_graph()


def _tables(graph, kind, package):
    ei, n = graph
    return package.build_bsda_for_kind(ei, n, kind, depth=3, a_dtype="int8",
                                       transpose=False)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_same(a, b, name):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_pad_and_partition_match_jax(graph, n_dev):
    for kind in ("sage", "gcn", "gat"):
        use_kernel = kind != "gat"
        gj = jax_bsda.pad_bsda_chunks(_tables(graph, kind, jax_bsda), n_dev)
        gp = bsda.pad_bsda_chunks(_tables(graph, kind, bsda), n_dev)
        assert gp.num_chunks == gj.num_chunks == 24 and gp.n_pad == gj.n_pad
        for f in ("a", "a_packed", "src_chunk", "dst_scale", "src_scale", "slot_occ"):
            if getattr(gj, f) is None:
                assert getattr(gp, f) is None, f
            else:
                _assert_same(getattr(gj, f), getattr(gp, f), f"{kind} {f}")
        sj = jax_sm.partition_bsda(gj, n_dev, use_pallas=use_kernel)
        sp = shardmap_step.partition_bsda(gp, n_dev, use_kernel=use_kernel)
        assert sp.halo_chunks == 2 and sp.use_kernel == use_kernel
        if use_kernel:
            assert sp.hal_dst.shape[1] > 0 and sp.a_t_p is not None
        assert sp.res_rows.shape[1] > 1 and len(sp.res_nbr) > 1
        for field in dataclasses.fields(sj):
            if field.name == "axis_name":  # the port's shards carry a group instead
                continue
            want = getattr(sj, field.name)
            got = getattr(sp, "use_kernel" if field.name == "use_pallas" else field.name)
            name = f"{kind} n={n_dev} {field.name}"
            if isinstance(want, tuple):
                assert len(got) == len(want), name
                for k, (a, b) in enumerate(zip(want, got)):
                    _assert_same(a, b, f"{name}[{k}]")
            elif want is None:
                assert got is None, name
            elif hasattr(want, "shape"):
                _assert_same(want, got, name)
            else:
                assert got == want, (name, got, want)


@pytest.mark.parametrize("kind", ["sage", "gcn"])
def test_shard_local_aggregate_matches_jax(graph, kind):
    """Every shard of n = 4 through its aggregation (on CPU tensors the
    kernel route's Function runs the kernel's plain version) with the halo
    rows taken from the global x; the shards' rows concatenated and the
    gradient of sum(out * w) summed back onto x against the JAX
    single-device SpMM and jax.grad."""
    n_dev, feat = 4, 16
    gj = _tables(graph, kind, jax_bsda)
    g = bsda.pad_bsda_chunks(_tables(graph, kind, bsda), n_dev)
    sg = shardmap_step.partition_bsda(g, n_dev, use_kernel=True)
    n0, n_rows = graph[1], g.num_chunks * g.chunk
    x_np, w_np = np.random.default_rng(2).standard_normal((n_rows, feat)).astype(
        np.float32), np.random.default_rng(3).standard_normal(feat).astype(np.float32)
    x_np[n0:] = 0.0
    want = np.asarray(jax_bsda.bsda_spmm(gj, jnp.asarray(x_np[:n0])))
    want_grad = np.asarray(jax.grad(
        lambda q: (jax_bsda.bsda_spmm(gj, q) * w_np).sum())(jnp.asarray(x_np[:n0])))

    x = torch.tensor(x_np, requires_grad=True)
    hc = sg.halo_chunks * sg.chunk
    n_loc = n_rows // n_dev
    outs = []
    for d in range(n_dev):
        lo, hi = d * n_loc - hc, (d + 1) * n_loc + hc
        x_ext = torch.cat([x.new_zeros((max(-lo, 0), feat)), x[max(lo, 0): min(hi, n_rows)],
                           x.new_zeros((max(hi - n_rows, 0), feat))])
        outs.append(shardmap_step.shard_local_aggregate(
            shardmap_step.shard_slice(sg, d), x_ext))
    out = torch.cat(outs)
    (out * torch.from_numpy(w_np)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[:n0], want, **AGG)
    np.testing.assert_allclose(x.grad.numpy()[:n0], want_grad, **AGG)


def test_aggregation_needs_the_kernel_tables(graph):
    """Tables built without the block transpose (GAT's) take no
    aggregation: the one route's backward reads the transpose."""
    g = bsda.pad_bsda_chunks(_tables(graph, "sage", bsda), 2)
    one = shardmap_step.shard_slice(shardmap_step.partition_bsda(g, 2, use_kernel=False), 0)
    n_ext = (one.a.shape[1] + 2 * one.halo_chunks) * one.chunk
    with pytest.raises(ValueError, match="use_kernel=True"):
        shardmap_step.shard_local_aggregate(one, torch.zeros(n_ext, 4))


def test_shard_views_are_kernel_ready(graph):
    """A rank's slice holds its own contiguous tables: the kernel route's
    views read int32 source chunks and 16-byte-aligned planes; the pads
    the JAX scatters drop are cut off."""
    g = bsda.pad_bsda_chunks(_tables(graph, "sage", bsda), 4)
    sg = shardmap_step.partition_bsda(g, 4, use_kernel=True)
    for d in range(4):
        one = shardmap_step.shard_slice(sg, d)
        assert one.rank == d and one.a.shape[0] == 1
        for view in (shardmap_step._local_view(one), shardmap_step._transpose_view(one)):
            assert view.src_chunk.dtype == torch.int32
            for t in (view.a, view.a_packed, view.src_chunk, view.dst_scale,
                      view.src_scale):
                if t is not None:
                    assert t.is_contiguous() and t.data_ptr() % 16 == 0
        n_loc = one.a.shape[1] * one.chunk
        assert bool((one.hal_dst < one.a.shape[1]).all())
        assert bool((one.res_rows < n_loc).all())
        n_ext = n_loc + 2 * one.halo_chunks * one.chunk
        assert one.rest_rows.numel() == int((sg.rest_rows[d] < n_ext).sum())


def test_pad_to_multiple_matches_jax():
    from elliptic_gnn_tpu.parallel.sharded import pad_to_multiple as jax_pad
    from elliptic_gnn_tpu_torch.parallel import pad_to_multiple

    a = np.arange(30, dtype=np.int32).reshape(10, 3)
    for m, axis, fill in ((4, 0, 0), (5, 0, 1), (2, 1, -1), (3, 1, 7)):
        _assert_same(jax_pad(a, m, axis, fill), pad_to_multiple(a, m, axis, fill),
                     f"m={m} axis={axis}")


def test_segment_ops_match_jax():
    rng = np.random.default_rng(4)
    e, n, f = 500, 40, 3
    data = rng.standard_normal((e, f)).astype(np.float32)
    ids = rng.integers(0, n - 5, e)  # the last segments stay empty
    src = rng.integers(0, n, e)
    w = rng.standard_normal(e).astype(np.float32)
    x = rng.standard_normal((n, f)).astype(np.float32)
    t, ti = torch.from_numpy, torch.from_numpy(ids)
    tol = dict(rtol=1e-6, atol=1e-6)
    for name in ("segment_sum", "segment_mean", "segment_max"):
        want = np.asarray(getattr(jax_segment, name)(jnp.asarray(data), jnp.asarray(ids), n))
        got = getattr(segment, name)(t(data), ti, n).numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **tol)
    np.testing.assert_allclose(
        segment.segment_softmax(t(data), ti, n).numpy(),
        np.asarray(jax_segment.segment_softmax(jnp.asarray(data), jnp.asarray(ids), n)), **tol)
    for mean in (False, True):
        np.testing.assert_allclose(
            segment.spmm_edge_list(t(x), t(src), ti, n, t(w), mean=mean).numpy(),
            np.asarray(jax_segment.spmm_edge_list(
                jnp.asarray(x), jnp.asarray(src), jnp.asarray(ids), n,
                jnp.asarray(w), mean=mean)), **tol)


def test_null_logger_takes_every_run_logger_call(tmp_path):
    public = {k for k in vars(RunLogger) if not k.startswith("_")}
    assert public <= {k for k in vars(NullLogger) if not k.startswith("_")}
    log = NullLogger()
    log.log_epoch(1, 0.5, 0.25, extras={"lr": 1e-3})
    log.log_epoch(2, 0.4, 0.3)
    log.close()
    assert not os.listdir(tmp_path)


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    cfg = {"seed": 4, "t_train_end": 6, "t_val_end": 8, "t_max": 10,
           "synthetic": True, "synthetic_nodes": 1500,
           "processed_dir": str(root / "processed"), "data_dir": str(root / "raw")}
    jax_build_graph.main(cfg)
    return cfg["processed_dir"]


def mesh_cfg(processed, out, **kw):
    cfg = {"seed": 0, "processed_dir": processed, "output_root": str(out),
           "device": "cpu", "arch": "sage_resbn", "hidden_dim": 16, "layers": 3,
           "dropout": 0.0, "lr": 0.01, "weight_decay": 0.0, "max_epochs": 6,
           "patience": 6, "time_embed_dim": 2, "time_embed_type": "sin",
           "max_timestep": 10, "symmetrize_edges": True,
           "calibrate_temperature": False}
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("k", [1, 4])
def test_mesh_one_matches_single_device_and_predicts(processed, tmp_path, k):
    """`aggregation: shard_map` at `mesh_devices: 1`: the halo path in a
    world of one (serial loop and K = 4), against the single-device run;
    predict and rebuild_on score its run dir with the single-device
    encoding, as the trainer's scoring pass did."""
    import torch.distributed as dist

    one = train_gnn.main(mesh_cfg(processed, tmp_path, run_name="single",
                                  epochs_per_sync=k))
    sm = train_gnn.main(mesh_cfg(processed, tmp_path, run_name="sm1",
                                 aggregation="shard_map", epochs_per_sync=k))
    assert not dist.is_initialized()
    assert sm["mesh_devices"] == 1 and sm["epochs_run"] == one["epochs_run"]
    for key in ("pr_auc_illicit", "best_val_pr_auc", "roc_auc"):
        assert abs(sm[key] - one[key]) < 1e-6, key
    out = os.path.join(str(tmp_path), "gnn", "sm1")
    node_idx, probs, _, _, _ = predict.predict(out, device="cpu")
    idx = np.load(os.path.join(out, "node_idx_test.npy"))
    np.testing.assert_allclose(probs[idx], np.load(os.path.join(out, "scores_test.npy")),
                               atol=1e-6)


def test_pick_aggregation_on_a_mesh_matches_jax():
    """`auto` on a mesh of more than one rank is the halo path, as in the
    JAX trainer; a pinned value is kept on a mesh (the GSPMD row sharding,
    train_gnn._shard); mini_batch stays on the ELL."""
    from elliptic_gnn_tpu.train import train_gnn as jax_train

    for kind in ("sage", "gcn", "gat"):
        for cfg in ({"mesh_devices": 8}, {"mesh_devices": 1}, {},
                    {"mesh_devices": 8, "aggregation": "bsda"},
                    {"mesh_devices": 8, "aggregation": "ell"},
                    {"mesh_devices": 8, "mini_batch": True},
                    {"mesh_devices": 1, "aggregation": "shard_map"}):
            assert train_gnn._pick_aggregation(cfg, kind) == \
                jax_train._pick_aggregation(cfg, None, kind), (kind, cfg)
    for agg in ("bsda", "bsda_pallas", "ell"):
        assert train_gnn._pick_aggregation({"aggregation": agg}, "sage", 4) == agg
    assert train_gnn._pick_aggregation({"mini_batch": True}, "sage", 4) == "ell"
    assert train_gnn._pick_aggregation({"aggregation": "shard_map"}, "sage", 4) == "shard_map"


def test_unbanded_graph_raises_or_is_refused(processed, monkeypatch, capsys):
    """A graph that partition_bsda rejects: an explicit `aggregation:
    shard_map` raises its ValueError, as in the JAX trainer; under `auto`
    the run falls back to the GSPMD row sharding, as the JAX trainer does,
    on tables rebuilt with their transpose (the multi-rank run:
    tests/test_torch_port_multihost.py)."""
    from elliptic_gnn_tpu_torch.parallel.gspmd_step import RowShardedBsda
    from elliptic_gnn_tpu_torch.parallel.mesh import Mesh

    def reject(*args, **kwargs):
        raise ValueError("synthetic non-banded rejection (test)")

    monkeypatch.setattr(train_gnn, "partition_bsda", reject)
    cfg = mesh_cfg(processed, "unused")
    data, gops = train_gnn.build_graph_ops(cfg, train_gnn.prepare_data(cfg),
                                           torch.device("cpu"))
    mesh = Mesh(size=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="non-banded rejection"):
        train_gnn._shard(dict(cfg, aggregation="shard_map"), data, gops, mesh)
    capsys.readouterr()
    ops, inputs = train_gnn._shard(dict(cfg, mesh_devices=2), data, gops, mesh)
    out = capsys.readouterr().out
    assert "falling back to GSPMD einsum" in out and "GSPMD), rank 0" in out
    assert isinstance(ops, RowShardedBsda) and ops.bwd is not None
    assert inputs.x.shape[0] == ops.n_loc == ops.n_rows // 2


def test_mesh_larger_than_the_cards_raises(monkeypatch):
    from elliptic_gnn_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        mesh.check_devices(2, "cuda")
    mesh.check_devices(1, "cuda")
    mesh.check_devices(8, "cpu")  # gloo ranks share the host
    assert mesh.rank_device(5, "cpu") == torch.device("cpu")
    assert mesh.backend_for("cuda") == "nccl" and mesh.backend_for("cpu") == "gloo"
