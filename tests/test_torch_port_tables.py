"""Port parity: the torch package's host-side graph code (synthetic graph,
BFS renumbering, BSDA/ELL table builder) against the JAX package, table for
table on the same inputs. Integer tables and indices must be equal; float
scales and weights are computed by the same numpy code and must be equal
too (no tolerance)."""
import dataclasses

import numpy as np
import pytest
import torch

from elliptic_gnn_tpu import native as jax_native
from elliptic_gnn_tpu.graph import synthetic as jax_synth
from elliptic_gnn_tpu.graph.transform import symmetrize_edges as jax_symmetrize
from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu_torch import native as port_native
from elliptic_gnn_tpu_torch.graph import synthetic as port_synth
from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges
from elliptic_gnn_tpu_torch.kernels import bsda as port_bsda


def port_graph(n, t_blocks, avg_deg, seed, n_far=0):
    """Random intra-block edges (+ `n_far` arbitrary ones to force spill),
    symmetrized and BFS-renumbered with the port's bfs_order.
    Returns (edge_index [2, E] int64, block_ids [n])."""
    rng = np.random.default_rng(seed)
    sizes = rng.multinomial(n - t_blocks, np.ones(t_blocks) / t_blocks) + 1
    block_ids = np.repeat(np.arange(t_blocks), sizes)
    starts = np.r_[0, np.cumsum(sizes)[:-1]]
    srcs, dsts = [], []
    for b in range(t_blocks):
        lo, sz = starts[b], sizes[b]
        m = int(avg_deg * sz)
        srcs.append(rng.integers(lo, lo + sz, m))
        dsts.append(rng.integers(lo, lo + sz, m))
    if n_far:
        srcs.append(rng.integers(0, n, n_far))
        dsts.append(rng.integers(0, n, n_far))
    ei = np.stack([np.concatenate(srcs), np.concatenate(dsts)]).astype(np.int64)
    ei = np.concatenate([ei, ei[::-1]], axis=1)
    rank = port_bsda.bfs_order(ei, n, block_ids)
    return rank[ei].astype(np.int64), block_ids


def _np(v):
    """numpy view of a table; bf16 widened to f32 (exact)."""
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_tables_equal(gj, gp, path="g"):
    """Field-by-field equality of a JAX BsdaGraph/EllGraph and the port's."""
    assert type(gj).__name__ == type(gp).__name__, path
    for field in dataclasses.fields(gp):
        name = field.name
        vj, vp = getattr(gj, name), getattr(gp, name)
        where = f"{path}.{name}"
        if vp is None or vj is None:
            assert vp is None and vj is None, where
        elif dataclasses.is_dataclass(vp):
            assert_tables_equal(vj, vp, where)
        elif isinstance(vp, tuple) and vp and isinstance(vp[0], torch.Tensor):
            assert len(vj) == len(vp), where
            for i, (a, b) in enumerate(zip(vj, vp)):
                np.testing.assert_array_equal(_np(a), _np(b), err_msg=f"{where}[{i}]")
        elif isinstance(vp, torch.Tensor):
            np.testing.assert_array_equal(_np(vj), _np(vp), err_msg=where)
        else:
            assert vj == vp, (where, vj, vp)


def test_synthetic_generate_bit_identical():
    kw = dict(num_nodes=1500, num_features=12, num_timesteps=7, seed=3)
    dj, dp = jax_synth.generate(**kw), port_synth.generate(**kw)
    for name in ("x", "y", "timestep", "edge_index"):
        a, b = getattr(dj, name), getattr(dp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(
        jax_symmetrize(dj).edge_index, symmetrize_edges(dp).edge_index)


@pytest.mark.parametrize("bfs", ["native", "python"])
def test_bfs_order_matches(monkeypatch, bfs):
    if bfs == "python":
        monkeypatch.setattr(jax_native, "bfs_order", lambda *a: None)
        monkeypatch.setattr(port_native, "bfs_order", lambda *a: None)
    data = port_synth.generate(num_nodes=900, num_features=4,
                               num_timesteps=5, seed=11)
    ei = symmetrize_edges(data).edge_index
    # shuffle node ids so the block relabelling path runs too
    perm = np.random.default_rng(0).permutation(data.num_nodes)
    ei_s, ts_s = perm[ei], np.empty_like(data.timestep)
    ts_s[perm] = data.timestep
    for edges, ts in ((ei, data.timestep), (ei_s, ts_s)):
        rj = jax_bsda.bfs_order(edges, data.num_nodes, ts)
        rp = port_bsda.bfs_order(edges, data.num_nodes, ts)
        np.testing.assert_array_equal(rj, rp)
        assert sorted(rp.tolist()) == list(range(data.num_nodes))


@pytest.mark.parametrize("kind", ["sage", "gcn"])
@pytest.mark.parametrize("a_dtype", ["int8", "float32"])
def test_build_bsda_for_kind_matches(kind, a_dtype):
    ei, _ = port_graph(700, 3, 1.5, seed=5, n_far=60)
    n = 700
    gj = jax_bsda.build_bsda_for_kind(ei, n, kind, depth=3, a_dtype=a_dtype,
                                      transpose=True)
    gp = port_bsda.build_bsda_for_kind(ei, n, kind, depth=3, a_dtype=a_dtype,
                                       transpose=True)
    assert gp.residual is not None and gp.transpose is not None
    if a_dtype == "int8":
        assert gp.a_packed is not None and gp.a_pack == 4
        assert gp.transpose.a_packed is not None
    assert_tables_equal(gj, gp)


@pytest.mark.parametrize("depth", [2, 3])
def test_build_bsda_gat_matches(depth):
    """GAT tables: self-loops, unit weights, always int8 multiplicities
    (duplicate edges give values > 1), slot_occ, no transpose."""
    ei, _ = port_graph(700, 3, 1.5, seed=9, n_far=60)
    ei = np.concatenate([ei, ei[:, :50]], axis=1)
    n = 700
    gj = jax_bsda.build_bsda_for_kind(ei, n, "gat", depth=depth, transpose=False)
    gp = port_bsda.build_bsda_for_kind(ei, n, "gat", depth=depth, transpose=False)
    assert gp.a.dtype == torch.int8 and int(gp.a.max()) > 1
    assert gp.residual is not None and gp.transpose is None
    assert gp.slot_occ is not None and gp.dst_scale is None
    assert_tables_equal(gj, gp)


def test_gat_transpose_tables_raise():
    """transpose=True no longer raises for 'gat': it attaches
    gat_block_transpose's tables (held against the JAX package's in
    tests/test_torch_port_gat_bwd2.py). An unknown kind still raises."""
    ei, _ = port_graph(300, 2, 1.5, seed=9)
    g = port_bsda.build_bsda_for_kind(ei, 300, "gat", depth=3, transpose=True)
    assert g.transpose is not None and g.transpose.residual is None
    assert int(g.transpose.a.sum()) == int(g.a.sum())
    with pytest.raises(ValueError, match="sage/gcn/gat"):
        port_bsda.build_bsda_for_kind(ei, 300, "gin", depth=3, transpose=True)


def test_pack_a_planes_roundtrip():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 4, (3, 5, 8, 8))
    for pack in (2, 4):
        pj = np.asarray(jax_bsda.pack_a_planes(a, pack))
        pp = port_bsda.pack_a_planes(a, pack)
        np.testing.assert_array_equal(pj, pp)
        bits = 8 // pack
        for d in range(a.shape[1]):
            got = (pp[:, d // pack] >> (bits * (d % pack))) & ((1 << bits) - 1)
            np.testing.assert_array_equal(got, a[:, d])
