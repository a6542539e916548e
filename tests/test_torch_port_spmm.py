"""Port parity: the plain PyTorch BSDA SpMM (forward and autograd backward
through the transpose tables) against the JAX package's Pallas kernel
(interpret mode off-TPU, as tests/test_pallas_bsda.py runs it) and its XLA
bsda_spmm, on the same tables and inputs. The CUDA kernel is held against
the plain version in tests/test_torch_port_cuda.py. The ELL encoding's flat
tables (the ELL kernel's) are held against A and A^T from the edge list,
and the encodings that keep the gathers against ell_weighted_sum.

Tolerances: f32 rtol 1e-4, atol 1e-5 (f32 sums in another order); bf16
(amp) atol 2e-2, rtol 2e-2 (one bf16 rounding of the result, ~2^-8
relative, on values of order 1, plus different summation orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.kernels.pallas_bsda import pallas_bsda_spmm
from elliptic_gnn_tpu_torch.kernels import bsda as port_bsda
from elliptic_gnn_tpu_torch.kernels import spmm
from tests.test_torch_port_tables import port_graph
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(n, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    ct = rng.standard_normal((n, f)).astype(np.float32)
    return x, ct


def _port_fwd_bwd(g, x, ct, compute_dtype=None):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm(g, xt, compute_dtype=compute_dtype)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


def _jax_fwd_bwd(fn, x, ct):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("mean", [False, True])
def test_plain_matches_pallas_float_tables(mean):
    """f32 tables (mean folded or unit weights), F=96: not a 128 multiple."""
    n, f = 600, 96
    ei, _ = port_graph(n, 3, 1.5, seed=23, n_far=40)
    gj = jax_bsda.build_bsda(ei, n, mean=mean, depth=2)
    gp = port_bsda.build_bsda(ei, n, mean=mean, depth=2)
    assert gp.residual is not None
    x, _ = _inputs(n, f, 23)
    out_p = spmm(gp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_p, np.asarray(pallas_bsda_spmm(gj, jnp.asarray(x))), **F32)
    np.testing.assert_allclose(out_p, np.asarray(jax_bsda.bsda_spmm(gj, jnp.asarray(x))), **F32)


@pytest.mark.parametrize("kind", ["sage", "gcn"])
@pytest.mark.parametrize("f", [32, 168])
def test_plain_fwd_bwd_matches_xla_factored(kind, f):
    """Factored int8 tables with spill and transpose: forward and the
    gradient through the transpose tables against the XLA path."""
    n = 700
    ei, _ = port_graph(n, 3, 1.5, seed=5, n_far=60)
    gj = jax_bsda.build_bsda_for_kind(ei, n, kind, depth=3, a_dtype="int8")
    gp = port_bsda.build_bsda_for_kind(ei, n, kind, depth=3, a_dtype="int8")
    x, ct = _inputs(n, f, 7)
    out_p, grad_p = _port_fwd_bwd(gp, x, ct)
    out_j, grad_j = _jax_fwd_bwd(lambda z: jax_bsda.bsda_spmm(gj, z), x, ct)
    np.testing.assert_allclose(out_p, out_j, **F32)
    np.testing.assert_allclose(grad_p, grad_j, **F32)


@pytest.mark.parametrize("amp", [False, True])
def test_plain_fwd_bwd_matches_pallas_packed(amp):
    """The main-path encoding (sage, int8, bit-packed planes, transpose,
    spill) at F=168 against the Pallas kernel, f32 and bf16 (amp)."""
    n, f = 700, 168
    ei, _ = port_graph(n, 3, 1.5, seed=9, n_far=60)
    gj = jax_bsda.build_bsda_for_kind(ei, n, "sage", depth=3, a_dtype="int8")
    gj = dataclasses.replace(gj, use_pallas_kernel=True)
    gp = port_bsda.build_bsda_for_kind(ei, n, "sage", depth=3, a_dtype="int8")
    assert gp.a_pack == 4 and gp.residual is not None
    cdt_j = jnp.bfloat16 if amp else None
    cdt_p = torch.bfloat16 if amp else None
    x, ct = _inputs(n, f, 13)
    out_p, grad_p = _port_fwd_bwd(gp, x, ct, cdt_p)
    out_j, grad_j = _jax_fwd_bwd(
        lambda z: pallas_bsda_spmm(gj, z, compute_dtype=cdt_j), x, ct)
    tol = BF16 if amp else F32
    np.testing.assert_allclose(out_p, out_j, **tol)
    np.testing.assert_allclose(grad_p, grad_j, **tol)


def test_plain_without_transpose_uses_autograd():
    """No transpose tables: autograd differentiates the plain ops; the
    gradient must equal the one through the transpose tables."""
    n, f = 500, 32
    ei, _ = port_graph(n, 2, 2.0, seed=3, n_far=30)
    g = port_bsda.build_bsda_for_kind(ei, n, "sage", depth=3, a_dtype="int8")
    g_nt = dataclasses.replace(g, transpose=None)
    x, ct = _inputs(n, f, 3)
    out_a, grad_a = _port_fwd_bwd(g, x, ct)
    out_b, grad_b = _port_fwd_bwd(g_nt, x, ct)
    np.testing.assert_allclose(out_b, out_a, **F32)
    np.testing.assert_allclose(grad_b, grad_a, **F32)



@pytest.mark.parametrize("mean", [False, True])
def test_ell_spmm_matches(mean):
    """The plain ELL aggregation (the spill's encoding) against the JAX
    ell_spmm, weighted edges, with and without mean."""
    from elliptic_gnn_tpu.kernels.ell import build_ell_graph as jax_build_ell
    from elliptic_gnn_tpu.kernels.ell import ell_spmm as jax_ell_spmm
    from elliptic_gnn_tpu_torch.kernels.ell import build_ell_graph, ell_spmm

    n, f = 400, 24
    ei, _ = port_graph(n, 2, 1.5, seed=31)
    w = np.random.default_rng(31).random(ei.shape[1]).astype(np.float32)
    x, _ = _inputs(n, f, 31)
    gj = jax_build_ell(ei, n, edge_weights=w, mean=mean)
    gp = build_ell_graph(ei, n, edge_weights=w, mean=mean)
    np.testing.assert_allclose(
        ell_spmm(gp, torch.from_numpy(x)).numpy(),
        np.asarray(jax_ell_spmm(gj, jnp.asarray(x))), **F32)


# ---------------- the ELL kernel's flat tables (kernels/ell.py) ----------------

def _ell_edges(n, seed):
    """Random directed edges with repeats, a hub of more than
    ell.LONG_DEGREE in-edges, and nodes n - 3 .. n - 1 left isolated."""
    from elliptic_gnn_tpu_torch.kernels import ell

    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n - 3, size=(2, 3 * n))
    hub = np.stack([np.arange(1, ell.LONG_DEGREE + 9), np.zeros(ell.LONG_DEGREE + 8, int)])
    return np.concatenate([ei, hub, ei[:, :5]], axis=1).astype(np.int64)


def _dense_a(ei, n, kind):
    """A [n, n] in f64 from the edge list alone: sage's mean over the
    in-edges, gcn's symmetric norm with self-loops."""
    from elliptic_gnn_tpu_torch.graph.transform import add_self_loops
    from elliptic_gnn_tpu_torch.kernels.ell import gcn_norm_weights

    a = np.zeros((n, n))
    if kind == "sage":
        np.add.at(a, (ei[1], ei[0]), 1.0)
        return a / np.maximum(a.sum(axis=1, keepdims=True), 1.0)
    ei = add_self_loops(ei, n)
    np.add.at(a, (ei[1], ei[0]), gcn_norm_weights(ei, n).astype(np.float64))
    return a


def _flat_dense(t):
    """The dense matrix of EllTables t, and the number of its entries."""
    rp = t.row_ptr.numpy().astype(np.int64)
    rows = np.repeat(np.arange(rp.size - 1), np.diff(rp))
    w = t.weight.numpy().astype(np.float64)
    if t.scale is not None:
        w = w * t.scale.numpy()[rows]
    a = np.zeros((rp.size - 1, t.n_src))
    np.add.at(a, (rows, t.col.numpy()), w)
    return a, int(rp[-1])


@pytest.mark.parametrize("kind", ["sage", "gcn"])
@pytest.mark.parametrize("renumber", [False, True])
def test_ell_flat_tables_match_dense(kind, renumber):
    """The flat tables and their transpose against A and A^T built from the
    edge list, renumbered or not (then in the relabelled order); one entry
    an edge (no padding slot: no zero weight), int32 indices, the long rows
    listed, zero-degree rows empty."""
    from elliptic_gnn_tpu_torch.kernels import ell
    from elliptic_gnn_tpu_torch.models import prepare_graph_ops

    n = 120
    ei = _ell_edges(n, seed=5)
    g = prepare_graph_ops(ei, n, kind)
    a = _dense_a(ei, n, kind)
    if renumber:
        g, rank = ell.renumber_for_ell(g)
        perm = np.argsort(rank)
        a = a[perm][:, perm]
    g = ell.with_flat_tables(g, transpose=True)
    n_edges = ei.shape[1] + (n if kind == "gcn" else 0)
    for t, want in ((g.flat, a), (g.flat_t, a.T)):
        got, nnz = _flat_dense(t)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert nnz == n_edges and not (t.weight == 0).any()
        assert t.row_ptr.dtype == t.col.dtype == t.long_rows.dtype == torch.int32
        deg = np.diff(t.row_ptr.numpy())
        assert t.long_rows.tolist() == np.nonzero(deg > ell.LONG_DEGREE)[0].tolist()
    assert g.flat.long_rows.numel() == 1 and g.flat_t.scale is None
    zero = np.diff(g.flat.row_ptr.numpy()) == 0
    assert zero.sum() == g.n_zero_deg and (zero[-3:].all() if kind == "sage" else not zero.any())


@pytest.mark.parametrize("kind", ["sage", "gcn"])
def test_ell_graph_spmm_on_cpu_is_the_plain_version(kind):
    """EllGraph.spmm with the flat tables on CPU tensors: ell_weighted_sum's
    values and gradients, bit for bit (the kernel runs on CUDA tensors
    only); the tables survive .to() and renumber_for_ell drops them."""
    from elliptic_gnn_tpu_torch.kernels import ell
    from elliptic_gnn_tpu_torch.models import prepare_graph_ops

    n, f = 120, 7
    g = prepare_graph_ops(_ell_edges(n, seed=6), n, kind)
    gt = ell.with_flat_tables(g, transpose=True).to("cpu")
    assert gt.flat is not None and gt.flat_t is not None
    assert ell.renumber_for_ell(gt)[0].flat is None
    x, ct = (torch.from_numpy(a) for a in _inputs(n, f, 6))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    out_a, out_b = spmm(gt, xa), ell.ell_weighted_sum(g, xb)
    (out_a * ct).sum().backward()
    (out_b * ct).sum().backward()
    assert torch.equal(out_a, out_b) and torch.equal(xa.grad, xb.grad)


def test_ell_tables_only_where_build_graph_ops_makes_them():
    """train_gnn.build_graph_ops's ELL branch: the flat tables, with their
    transpose for training only; none under mini_batch. The encodings that
    keep the gathers carry none: models.prepare_graph_ops (the explainer's
    and the hub ablation's), the BSDA spill, a sampler batch's, and the
    GSPMD rows cut from a graph that has them."""
    from elliptic_gnn_tpu_torch.graph import synthetic
    from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges
    from elliptic_gnn_tpu_torch.kernels import ell
    from elliptic_gnn_tpu_torch.models import prepare_graph_ops
    from elliptic_gnn_tpu_torch.parallel import gspmd_step, sharded
    from elliptic_gnn_tpu_torch.parallel.mesh import Mesh
    from elliptic_gnn_tpu_torch.train import train_gnn
    from elliptic_gnn_tpu_torch.train.sampler import NeighborSampler

    data = symmetrize_edges(synthetic.generate(
        num_nodes=400, num_features=4, num_timesteps=4, seed=2))
    cpu = torch.device("cpu")
    cfg = {"arch": "sage_resbn", "aggregation": "ell"}
    _, g = train_gnn.build_graph_ops(cfg, data, cpu)
    assert g.flat is not None and g.flat_t is not None
    _, g_eval = train_gnn.build_graph_ops(cfg, data, cpu, training=False)
    assert g_eval.flat is not None and g_eval.flat_t is None
    _, g_mb = train_gnn.build_graph_ops(dict(cfg, mini_batch=True), data, cpu)
    assert g_mb.flat is None
    assert prepare_graph_ops(data.edge_index, data.num_nodes, "sage").flat is None
    ei, _ = port_graph(600, 3, 1.5, seed=23, n_far=40)
    spill = port_bsda.build_bsda(ei, 600, mean=True, depth=2)
    assert spill.residual is not None and spill.residual.flat is None
    sampler = NeighborSampler(data.edge_index, data.num_nodes, [3, 3], 16, "sage")
    assert sampler.sample_batch(np.arange(16))[1].flat is None
    mesh = Mesh(size=2, rank=0, device=cpu)
    rs = gspmd_step.row_sharded_ell(sharded.shard_ell_graph(g, mesh), 2, 0)
    assert rs.ell.flat is None and isinstance(g, ell.EllGraph)


def test_ell_paths_without_tables_run_ell_weighted_sum(monkeypatch):
    """The BSDA spill, ell_gat_aggregate, the GSPMD rows' row_ell_spmm (a
    world of one, its all-gather the identity) and a sampler batch's
    aggregation run ell_weighted_sum (or, for attention, the gathers), as
    before: each call counted, the kernel's entry never reached."""
    from elliptic_gnn_tpu_torch.graph import synthetic
    from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges
    from elliptic_gnn_tpu_torch.kernels import bsda, ell, ell_spmm_cuda
    from elliptic_gnn_tpu_torch.parallel import gspmd_step, sharded
    from elliptic_gnn_tpu_torch.parallel.mesh import Mesh
    from elliptic_gnn_tpu_torch.train.sampler import NeighborSampler

    calls = []
    real = ell.ell_weighted_sum

    def counted(g, x):
        calls.append(g.num_nodes)
        return real(g, x)

    def no_kernel(*a, **k):
        raise AssertionError("the ELL kernel's entry was reached")

    for mod in (ell, bsda, gspmd_step):
        monkeypatch.setattr(mod, "ell_weighted_sum", counted)
    monkeypatch.setattr(ell_spmm_cuda, "ell_spmm_cuda", no_kernel)
    ei, _ = port_graph(600, 3, 1.5, seed=23, n_far=40)
    g = port_bsda.build_bsda(ei, 600, mean=True, depth=2)
    spmm(g, torch.from_numpy(_inputs(600, 8, 3)[0]))
    assert calls == [g.residual.num_nodes]

    data = symmetrize_edges(synthetic.generate(
        num_nodes=300, num_features=4, num_timesteps=4, seed=4))
    sampler = NeighborSampler(data.edge_index, data.num_nodes, [3, 3], 16, "sage")
    sub = sampler.sample_batch(np.arange(16))[1]
    calls.clear()
    spmm(sub, torch.ones(sub.num_nodes, 4))
    assert calls == [sub.num_nodes]

    gt = ell.with_flat_tables(ell.build_ell_graph(data.edge_index, 300, mean=True), True)
    rs = gspmd_step.row_sharded_ell(sharded.shard_ell_graph(gt, Mesh(1, 0, "cpu")), 1, 0)
    monkeypatch.setattr(gspmd_step, "gather_rows_diff", lambda rs, x: x)
    calls.clear()
    x = torch.from_numpy(_inputs(300, 8, 4)[0])
    torch.testing.assert_close(gspmd_step.row_ell_spmm(rs, x), real(gt, x), rtol=0, atol=0)
    assert calls == [300]

    gat = ell.with_flat_tables(ell.build_ell_graph(data.edge_index, 300), True)
    xp = torch.randn(300, 2, 4)
    a_s, a_d = torch.randn(300, 2), torch.randn(300, 2)
    want = ell.ell_gat_aggregate(dataclasses.replace(gat, flat=None, flat_t=None),
                                 xp, a_s, a_d)
    assert torch.equal(gat.gat_attend(xp, a_s, a_d), want)
