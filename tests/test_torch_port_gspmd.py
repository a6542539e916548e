"""The GSPMD row sharding's tables and rectangular aggregation in one
process, against the JAX package (parallel/sharded.py, on the 8-device CPU
mesh of tests/conftest.py) and against the whole graph.

  - shard_ell_graph, _extend_for_padding and shard_graph_inputs give the
    JAX package's arrays (integers exact, floats bit-equal; a rank's rows
    are its block of them), and each rank's share of the BSDA tables
    (shard_bsda_graph) is what JAX places on that device;
  - each rank's rectangular slice, through the plain version of the BSDA
    kernel (forward and transpose tables), its spill, the chunk-pair
    attention and the ELL gather, gives the whole graph's rows (f32, within
    1e-6).

The multi-rank runs of the path (aggregation and its gradient against
JAX, a training step, the trainer, the `auto` fallback) are in
tests/test_torch_port_multihost.py, in the worlds of ranks started there."""
import jax
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.graph import make_temporal_masks as jax_masks
from elliptic_gnn_tpu.graph import synthetic as jax_synthetic
from elliptic_gnn_tpu.graph.transform import symmetrize_edges as jax_symmetrize
from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.kernels.ell import renumber_for_ell as jax_renumber
from elliptic_gnn_tpu.models import prepare_graph_ops as jax_prepare
from elliptic_gnn_tpu.parallel import make_mesh as jax_make_mesh
from elliptic_gnn_tpu.parallel import sharded as jax_sharded
from elliptic_gnn_tpu_torch.graph import make_temporal_masks, synthetic
from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges
from elliptic_gnn_tpu_torch.kernels import bsda, bsda_gat
from elliptic_gnn_tpu_torch.kernels.ell import ell_weighted_sum, renumber_for_ell
from elliptic_gnn_tpu_torch.models import prepare_graph_ops
from elliptic_gnn_tpu_torch.parallel import gspmd_step, sharded
from elliptic_gnn_tpu_torch.parallel.mesh import Mesh
from tests import torch_port_ranks as ranks
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

N_DEV = 8
CLOSE = dict(rtol=1e-6, atol=1e-6)
pytestmark = pytest.mark.skipif(len(jax.devices()) < N_DEV, reason="needs 8 virtual devices")


def _mesh(rank, n=N_DEV):
    return Mesh(size=n, rank=rank, device=torch.device("cpu"))


def _graphs(n=1203, seed=1):
    """The same symmetrized synthetic graph (n not a multiple of 8) in both
    packages, with temporal masks."""
    kw = dict(num_nodes=n, num_features=5, num_timesteps=12, seed=seed)
    dj = jax_symmetrize(jax_masks(jax_synthetic.generate(**kw), 8, 10))
    dp = symmetrize_edges(make_temporal_masks(synthetic.generate(**kw), 8, 10))
    return dj, dp


def _ell_pair(kind, renumber):
    dj, dp = _graphs()
    gj = jax_prepare(dj.edge_index, dj.num_nodes, kind)
    gp = prepare_graph_ops(dp.edge_index, dp.num_nodes, kind)
    if renumber:
        gj, _ = jax_renumber(gj)
        gp, _ = renumber_for_ell(gp)
    return gj, gp, dj.num_nodes


def _same_ell(gj, gp):
    assert (gp.num_nodes, gp.widths, gp.n_zero_deg) == (gj.num_nodes, gj.widths, gj.n_zero_deg)
    for field in ("nbrs", "weights", "rows", "row_scale"):
        for a, b in zip(getattr(gj, field), getattr(gp, field), strict=True):
            a = np.asarray(a)
            assert b.numpy().dtype.kind == a.dtype.kind, field
            np.testing.assert_array_equal(b.numpy(), a, err_msg=field)
    np.testing.assert_array_equal(gp.inv_perm.numpy(), np.asarray(gj.inv_perm))


@pytest.mark.parametrize("renumber", [False, True])
@pytest.mark.parametrize("kind", ["sage", "gcn"])
def test_extend_and_shard_ell_graph_match_jax(kind, renumber):
    gj, gp, n = _ell_pair(kind, renumber)
    n_padded = -(-n // N_DEV) * N_DEV
    ej = jax_sharded._extend_for_padding(gj, n_padded)
    ep = sharded._extend_for_padding(gp, n_padded)
    np.testing.assert_array_equal(ep.inv_perm.numpy(), np.asarray(ej.inv_perm))
    assert (ep.num_nodes, ep.n_zero_deg) == (ej.num_nodes, ej.n_zero_deg)
    _same_ell(jax_sharded.shard_ell_graph(ej, jax_make_mesh(N_DEV)),
              sharded.shard_ell_graph(ep, _mesh(0)))


def _bsda_pair(kind):
    dj, dp = _graphs()
    rank = bsda.bfs_order(dp.edge_index, dp.num_nodes, dp.timestep)
    ei = dp.renumber(rank).edge_index
    gj = jax_bsda.pad_bsda_chunks(
        jax_bsda.build_bsda_for_kind(ei, dp.num_nodes, kind, depth=3, a_dtype="int8"), N_DEV)
    gp = bsda.pad_bsda_chunks(
        bsda.build_bsda_for_kind(ei, dp.num_nodes, kind, depth=3, a_dtype="int8"), N_DEV)
    return gj, gp


@pytest.mark.parametrize("kind", ["sage", "gcn"])
def test_shard_bsda_graph_is_what_jax_places_per_device(kind):
    """Rank d's share of the tables, forward and transpose, equals the
    block that JAX's shard_bsda_graph puts on device d of the mesh; the
    column scales stay whole; the ranks' spill rows together are JAX's."""
    gj, gp = _bsda_pair(kind)
    mesh = jax_make_mesh(N_DEV)
    placed = jax_sharded.shard_bsda_graph(gj, mesh)
    devices = list(mesh.devices.flat)
    shares = [sharded.shard_bsda_graph(gp, _mesh(d)) for d in range(N_DEV)]
    for name, tj, views in (("forward", placed, [s.fwd for s in shares]),
                            ("transpose", placed.transpose, [s.bwd for s in shares])):
        for field in ("a", "src_chunk", "dst_scale"):
            arr = getattr(tj, field)
            if arr is None:
                assert all(getattr(v, field) is None for v in views), (name, field)
                continue
            for shard in arr.addressable_shards:
                got = getattr(views[devices.index(shard.device)], field)
                np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data),
                                              err_msg=f"{name} {field}")
        for v in views:
            if tj.src_scale is None:
                assert v.src_scale is None
            else:
                np.testing.assert_array_equal(v.src_scale.numpy(), np.asarray(tj.src_scale))
        if tj.residual_rows is not None:
            n_loc = gp.num_chunks * gp.chunk // N_DEV
            rows = np.concatenate([v.residual_rows.numpy() + d * n_loc
                                   for d, v in enumerate(views) if v.residual is not None])
            np.testing.assert_array_equal(rows, np.asarray(tj.residual_rows))


@pytest.mark.parametrize("encoding", ["bsda", "ell"])
def test_shard_graph_inputs_match_jax(encoding):
    """Every rank's node arrays, concatenated, are JAX's padded arrays; the
    padded row counts agree; a rank's tables are its share."""
    dj, dp = _graphs()
    if encoding == "bsda":
        gj, gp = _bsda_pair("sage")
    else:
        gj = jax_prepare(dj.edge_index, dj.num_nodes, "sage")
        gp = prepare_graph_ops(dp.edge_index, dp.num_nodes, "sage")
    want = jax_sharded.shard_graph_inputs(jax_make_mesh(N_DEV), dj, gj)
    parts = [sharded.shard_graph_inputs(_mesh(d), dp, gp, shard_tables=True)
             for d in range(N_DEV)]
    for i, name in enumerate(("x", "y", "timestep", "train_mask", "row_mask")):
        got = np.concatenate([p[i].numpy() for p in parts])
        np.testing.assert_array_equal(got, np.asarray(want[i]), err_msg=name)
    assert all(p[6] == want[6] for p in parts)
    kind = gspmd_step.RowShardedBsda if encoding == "bsda" else gspmd_step.RowShardedEll
    assert all(isinstance(p[5], kind) and p[5].rank == d for d, p in enumerate(parts))


def _band_tables(kind, n_dev):
    ei, n = ranks.band_graph()
    g = bsda.build_bsda_for_kind(ei, n, kind, depth=3 if kind != "gat" else 4,
                                 a_dtype="int8", transpose=kind != "gat")
    return bsda.pad_bsda_chunks(g, n_dev)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("kind", ["sage", "gcn"])
def test_rectangular_plain_slices_match_whole_graph(kind, n_dev):
    """Each rank's rectangular dense part (forward and transpose tables)
    and its whole slice with the spill give the whole graph's rows."""
    g = _band_tables(kind, n_dev)
    n_rows = g.num_chunks * g.chunk
    x = torch.from_numpy(ranks.agg_inputs(n_rows, 24, seed=3)[0])
    for table in (g, g.transpose):
        dense = bsda.bsda_dense_plain(table, x)
        full = bsda.bsda_forward(table, x, bsda.bsda_dense_plain)
        n_loc = n_rows // n_dev
        for d in range(n_dev):
            view = gspmd_step.bsda_row_slice(table, n_dev, d)
            rows = slice(d * n_loc, (d + 1) * n_loc)
            torch.testing.assert_close(bsda.bsda_dense_plain(view, x, n_loc), dense[rows],
                                       **CLOSE)
            torch.testing.assert_close(
                bsda.bsda_forward(view, x, bsda.bsda_dense_plain, n_out=n_loc), full[rows],
                **CLOSE)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_rectangular_gat_attention_matches_whole_graph(n_dev):
    """The chunk-pair attention of each rank's destination chunks (every
    row's payload, the rank's own a_dst) gives the whole graph's rows."""
    g = _band_tables("gat", n_dev)
    n_rows = g.num_chunks * g.chunk
    xp, a_s, a_d, _ = (torch.from_numpy(v) for v in ranks.gat_inputs(n_rows))
    want, _, _ = bsda_gat.attend(g, xp, a_s, a_d, 0.2)
    n_loc = n_rows // n_dev
    for d in range(n_dev):
        rs = gspmd_step.row_sharded_bsda(g, n_dev, d)
        rows = slice(d * n_loc, (d + 1) * n_loc)
        got, _, _ = bsda_gat.attend(rs.fwd, xp, a_s, a_d[rows], 0.2)
        torch.testing.assert_close(got, want[rows], **CLOSE)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("renumber", [False, True])
def test_row_sharded_ell_rows_match_whole_graph(renumber, n_dev):
    """Each rank's ELL rows (the gather of its destination rows from every
    padded row) give the whole padded graph's rows; a renumber_for_ell
    graph's rank needs no reorder gather (inv_perm None)."""
    _, gp, n = _ell_pair("gcn", renumber)
    n_rows = -(-n // n_dev) * n_dev
    g_sh = sharded.shard_ell_graph(sharded._extend_for_padding(gp, n_rows), _mesh(0, n_dev))
    x = torch.from_numpy(ranks.agg_inputs(n_rows, 12, seed=4)[0])
    want = ell_weighted_sum(g_sh, x)
    n_loc = n_rows // n_dev
    for d in range(n_dev):
        rs = gspmd_step.row_sharded_ell(g_sh, n_dev, d)
        assert (rs.ell.inv_perm is None) == renumber
        torch.testing.assert_close(ell_weighted_sum(rs.ell, x),
                                   want[d * n_loc: (d + 1) * n_loc], **CLOSE)
