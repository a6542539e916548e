"""Port parity for the two-sweep GAT backward: the transpose tables
(gat_block_transpose), the plain versions of the destination and source
sweeps, the grad payload G2, and the packed training step with the
two-sweep backward chosen, against the JAX package on the same tables and
numpy-seeded inputs. The JAX Pallas sweeps run in interpret mode under
EGNN_GAT_ONE_SWEEP=0, as tests/test_gat_bwd.py runs them on the CPU. The
CUDA kernels are held against the plain versions in
tests/test_torch_port_cuda.py.

The graph: n = 128 * 20 nodes (the TPU sweeps need more than 16 chunks),
60 far edges so that a residual spill exists, duplicate edges for
multiplicities > 1.

Tolerances: tables equal; the sweeps against the Pallas sweeps rtol 1e-5,
atol 1e-5 (the JAX package's own tolerance between its two backwards: the
same f32 sums in another order, a rank-1 separable exponent there); the
port's two backwards against each other the same; parameter gradients
rtol 5e-4, atol 5e-5 (as tests/test_torch_port_gat.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.kernels import pallas_gat, pallas_gat_bwd
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu_torch.kernels import bsda as port_bsda
from elliptic_gnn_tpu_torch.kernels import gat_bwd, gat_cuda, packed_gat
from elliptic_gnn_tpu_torch.models import build_model
from elliptic_gnn_tpu_torch.models.convert import params_from_jax
from elliptic_gnn_tpu_torch.train import train_gnn
from tests.test_torch_port_tables import assert_tables_equal, port_graph

N = 128 * 20
SLOPE = 0.2
SWEEP = dict(rtol=1e-5, atol=1e-5)
BWD = dict(rtol=5e-4, atol=5e-5)
HEADS = [(4, 8), (1, 2)]


def _edges():
    rng = np.random.default_rng(7)
    ei, _ = port_graph(N, 8, 1.5, seed=7, n_far=60)
    return np.concatenate([ei, ei[:, rng.integers(0, ei.shape[1], 40)]], axis=1)


@pytest.fixture(scope="module")
def graphs():
    """(JAX tables, port tables) at depth 4 with the transpose tables."""
    ei = _edges()
    gj = jax_bsda.build_bsda_for_kind(ei, N, "gat", depth=4, transpose=True)
    gp = port_bsda.build_bsda_for_kind(ei, N, "gat", depth=4, transpose=True)
    assert gp.residual is not None and int(gp.a.max()) > 1
    return gj, gp


@pytest.mark.parametrize("depth", [3, 4])
def test_gat_block_transpose_matches(depth):
    """(a) src_chunk, slot_occ, depth, max_chunk_dist and every other field
    of the transpose equal the JAX package's, and its planes equal the JAX
    package's with their last two axes swapped (the port stores them
    row-oriented: rows = sources, for its kernel's row walk); the port also
    bit-packs the transpose planes, which the JAX package does not."""
    ei = _edges()
    gj = jax_bsda.build_bsda_for_kind(ei, N, "gat", depth=depth, transpose=True)
    gp = port_bsda.build_bsda_for_kind(ei, N, "gat", depth=depth, transpose=True)
    t = gp.transpose
    assert t is not None and t.depth > depth and t.transpose is None
    pack, bits = t.a_pack, 8 // t.a_pack
    assert pack == gp.a_pack > 1  # the same multiplicities, the same packing
    assert t.a_packed.shape == (t.num_chunks, -(-t.depth // pack), 128, 128)
    packed = t.a_packed.numpy()
    for d in range(t.depth):
        np.testing.assert_array_equal(
            (packed[:, d // pack] >> (bits * (d % pack))) & ((1 << bits) - 1),
            t.a[:, d].numpy())
    assert_tables_equal(gj, dataclasses.replace(gp, transpose=dataclasses.replace(
        t, a=t.a.transpose(-1, -2).contiguous(), a_packed=None, a_pack=1)))
    np.testing.assert_array_equal(
        t.a.numpy(), np.swapaxes(np.asarray(gj.transpose.a), -1, -2))
    # gat_block_transpose called alone gives the same tables
    again = port_bsda.gat_block_transpose(dataclasses.replace(gp, transpose=None))
    assert_tables_equal(t, again)
    # every dense edge once, filled slots first, padding slots self-pointing
    assert int(t.a.sum()) == int(gp.a.sum())
    filled = torch.arange(t.depth)[None, :] < t.slot_occ[:, None]
    assert not t.a[~filled].any() and t.a[filled].reshape(-1, 128 * 128).any(dim=1).all()
    own = torch.arange(t.num_chunks, dtype=torch.int32)[:, None].expand(-1, t.depth)
    assert torch.equal(t.src_chunk[~filled], own[~filled])


def _lanes(a, width):
    out = np.zeros((a.shape[0], width), np.float32)
    out[:, : a.shape[1]] = a
    return out


def _payload_and_g2(h, ch, seed):
    """Numpy payload [N, h*ch + 2h] and G2 [N, h*ch + 3h] in the raw gauge.
    The m columns hold a constant above every lrelu(t), so that the
    exponent stays negative as after a real forward."""
    rng = np.random.default_rng(seed)
    hc = h * ch
    pay = (0.3 * rng.standard_normal((N, hc + 2 * h))).astype(np.float32)
    g2 = np.empty((N, hc + 3 * h), np.float32)
    g2[:, : hc + h] = 0.3 * rng.standard_normal((N, hc + h))
    g2[:, hc + h: hc + 2 * h] = pay[:, hc + h:]
    g2[:, hc + 2 * h:] = 2.5
    return pay, g2


@pytest.mark.parametrize("h,ch", HEADS)
def test_plain_sweeps_match_pallas_sweeps(graphs, monkeypatch, h, ch):
    """(b) the plain destination + source sweeps against
    flash_gat_backward's two-sweep route in interpret mode."""
    gj, gp = graphs
    pay, g2 = _payload_and_g2(h, ch, 23)
    monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0")
    assert not pallas_gat_bwd.one_sweep_eligible(gj, h, ch)
    want = pallas_gat_bwd.flash_gat_backward(
        gj, jnp.asarray(_lanes(pay, pallas_gat.pack_width(h, ch))),
        jnp.asarray(_lanes(g2, pallas_gat_bwd.g2_pack_width(h, ch))), h, ch, SLOPE)
    assert want is not None
    want = np.asarray(want)[:, : pay.shape[1]]
    d_dst = gat_cuda.gat_bwd_dst_plain(gp, torch.from_numpy(g2), torch.from_numpy(pay),
                                       h, ch, SLOPE)
    d_src = gat_cuda.gat_bwd_src_plain(gp.transpose, torch.from_numpy(pay),
                                       torch.from_numpy(g2), h, ch, SLOPE)
    hc = h * ch
    assert not d_dst[:, : hc + h].any() and not d_src[:, hc + h:].any()
    np.testing.assert_allclose((d_dst + d_src).numpy(), want, **SWEEP)
    # a source sweep over the FORWARD tables reads them the wrong way round
    wrong = gat_cuda.gat_bwd_src_plain(gp, torch.from_numpy(pay), torch.from_numpy(g2),
                                       h, ch, SLOPE)
    assert not np.allclose(wrong.numpy()[:, : hc + h], want[:, : hc + h], **SWEEP)


@pytest.mark.parametrize("h,ch", HEADS)
@pytest.mark.parametrize("normalized", [False, True])
def test_two_sweep_matches_one_sweep_plain(graphs, h, ch, normalized):
    """(c) gat_bwd_two_sweep (grad_payload, then the two sweeps) against
    gat_bwd_plain on a real forward's output, in the raw and the val gauge."""
    _, gp = graphs
    rng = np.random.default_rng(29)
    w = gat_cuda.payload_width(h, ch)
    pay = torch.from_numpy((0.5 * rng.standard_normal((N, w))).astype(np.float32))
    gbar = torch.from_numpy(rng.standard_normal((N, w)).astype(np.float32))
    out_k = gat_cuda.gat_fwd(gp, pay, h, ch, SLOPE, normalized)
    want = gat_cuda.gat_bwd(gp, gbar, pay, out_k, h, ch, SLOPE, normalized)
    got = gat_cuda.gat_bwd_two_sweep(gp, gbar, pay, out_k, h, ch, SLOPE, normalized)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SWEEP)
    # G2 is always in the raw gauge: its A_bar and S_bar columns are the
    # cotangents of (acc, s) whatever the forward wrote
    g2 = gat_bwd.grad_payload(gbar, pay, out_k, h, ch, normalized)
    hc = h * ch
    assert g2.shape == (N, gat_cuda.g2_width(h, ch)) and g2.is_contiguous()
    np.testing.assert_array_equal(g2[:, hc + h: hc + 2 * h].numpy(), pay[:, hc + h:].numpy())
    np.testing.assert_array_equal(g2[:, hc + 2 * h:].numpy(), out_k[:, hc: hc + h].numpy())
    if not normalized:
        np.testing.assert_array_equal(g2[:, :hc].numpy(), gbar[:, :hc].numpy())
        np.testing.assert_array_equal(g2[:, hc: hc + h].numpy(), gbar[:, hc + h:].numpy())


@pytest.mark.parametrize("h,ch", HEADS)
@pytest.mark.parametrize("normalized", [False, True])
def test_fused_dst_plain_is_grad_payload_then_dst(graphs, h, ch, normalized):
    """(c') the plain version of the destination-sweep kernel, which now
    writes G2 itself: grad_payload's G2 bit for bit, and the d a_dst
    columns of gat_bwd_dst_plain over that G2, zeros elsewhere."""
    _, gp = graphs
    rng = np.random.default_rng(31)
    w = gat_cuda.payload_width(h, ch)
    pay = torch.from_numpy((0.5 * rng.standard_normal((N, w))).astype(np.float32))
    gbar = torch.from_numpy(rng.standard_normal((N, w)).astype(np.float32))
    out_k = gat_cuda.gat_fwd(gp, pay, h, ch, SLOPE, normalized)
    ct, g2 = gat_cuda.gat_bwd_dst_fused_plain(gp, gbar, pay, out_k, h, ch, SLOPE,
                                              normalized)
    want_g2 = gat_bwd.grad_payload(gbar, pay, out_k, h, ch, normalized)
    assert torch.equal(g2, want_g2)
    assert torch.equal(ct, gat_cuda.gat_bwd_dst_plain(gp, want_g2, pay, h, ch, SLOPE))
    assert not ct[:, : h * ch + h].any() and ct[:, h * ch + h:].abs().max() > 0


def _gat_setup(gp, seed=1, f_in=24):
    cfg = {"hidden_dim": 32, "layers": 2, "heads": 4, "dropout": 0.0}
    mj = jax_build_model("gat", f_in, cfg)
    params, state = mj.init(jax.random.PRNGKey(seed))
    mp = build_model("gat", f_in, cfg)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    params_from_jax(to_np(params), to_np(state), mp)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, f_in)).astype(np.float32)
    y = rng.integers(0, 2, N).astype(np.int64)
    return mj, params, state, mp, x, y


def _grads(mp):
    return [getattr(l, name).grad.clone() for l in mp.layers
            for name in ("w", "a_src", "a_dst", "b")]


def test_packed_step_two_sweep_grads_match(graphs, monkeypatch):
    """(d) the packed training step with the two-sweep backward chosen: its
    parameter gradients against autograd through forward_plain and against
    jax.grad through the JAX per-layer model, on a graph with a spill."""
    gj, gp = graphs
    mj, params, state, mp, x, y = _gat_setup(gp)
    calls = []
    real = gat_cuda.gat_bwd_two_sweep
    monkeypatch.setattr(packed_gat, "gat_bwd_two_sweep",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(packed_gat, "gat_bwd", None)  # the one-sweep must not run
    monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0")
    layer_params = [dict(w=l.w, a_src=l.a_src, a_dst=l.a_dst, b=l.b) for l in mp.layers]
    mp.train()
    logits = packed_gat.packed_gat_train_forward(layer_params, torch.from_numpy(x), gp)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    assert len(calls) == 2  # one per layer
    got = _grads(mp)

    mp.zero_grad()
    torch.nn.functional.cross_entropy(
        mp.forward_plain(torch.from_numpy(x), gp), torch.from_numpy(y)).backward()
    for a, b in zip(got, _grads(mp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **BWD)

    def loss_j(p):
        lg, _ = mj.apply(p, state, jnp.asarray(x), gj, training=True,
                         rng=jax.random.key(0))
        logp = jax.nn.log_softmax(lg, axis=1)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1).mean()

    l_j, g_j = jax.value_and_grad(loss_j)(params)
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-5)
    want = [np.asarray(gl[name]) for gl in g_j["layers"]
            for name in ("w", "a_src", "a_dst", "b")]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **BWD)


def _backward_taken(monkeypatch, g):
    """Which backward _AttendDense takes on tables g: 'one' or 'two'."""
    taken = []
    for name, attr, real in (("one", "gat_bwd", gat_cuda.gat_bwd),
                             ("two", "gat_bwd_two_sweep", gat_cuda.gat_bwd_two_sweep)):
        monkeypatch.setattr(
            packed_gat, attr,
            lambda *a, _n=name, _r=real, **k: taken.append(_n) or _r(*a, **k))
    pay = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (N, gat_cuda.payload_width(1, 2))).astype(np.float32)).requires_grad_(True)
    packed_gat._attend_packed(g, pay, 1, 2, SLOPE)[:, :2].sum().backward()
    assert len(taken) == 1
    return taken[0]


def test_backward_chooser(graphs, monkeypatch):
    """(e) one small function decides: the one-sweep backward by default,
    the two-sweep pair under EGNN_GAT_ONE_SWEEP=0 or
    torch.use_deterministic_algorithms(True); then tables without a
    transpose raise, with no way back to the one-sweep backward."""
    _, gp = graphs
    bare = dataclasses.replace(gp, transpose=None)
    monkeypatch.delenv("EGNN_GAT_ONE_SWEEP", raising=False)
    assert not packed_gat.use_two_sweep_backward()
    assert _backward_taken(monkeypatch, gp) == "one"
    assert _backward_taken(monkeypatch, bare) == "one"

    monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0")
    assert packed_gat.use_two_sweep_backward()
    assert _backward_taken(monkeypatch, gp) == "two"
    with pytest.raises(ValueError, match="transpose tables"):
        _backward_taken(monkeypatch, bare)
    monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "1")
    assert not packed_gat.use_two_sweep_backward()

    torch.use_deterministic_algorithms(True)
    try:
        assert packed_gat.use_two_sweep_backward()
        assert _backward_taken(monkeypatch, gp) == "two"
        with pytest.raises(ValueError, match="transpose tables"):
            _backward_taken(monkeypatch, bare)
    finally:
        torch.use_deterministic_algorithms(False)
    assert not packed_gat.use_two_sweep_backward()


def test_trainer_builds_transpose_only_for_two_sweep_training(tmp_path, monkeypatch):
    """The trainer asks the same function: GAT tables carry a transpose
    only for training with the two-sweep backward chosen; the run-dir
    loader (scoring, no backward) never builds one."""
    from elliptic_gnn_tpu_torch.graph import build_graph

    processed = str(tmp_path / "processed")
    build_graph.main({"seed": 0, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
                      "synthetic": True, "synthetic_nodes": 1500,
                      "processed_dir": processed})
    cfg = {"arch": "gat", "processed_dir": processed, "use_time_scalar": True}
    data = train_gnn.prepare_data(cfg)
    cpu = torch.device("cpu")
    monkeypatch.delenv("EGNN_GAT_ONE_SWEEP", raising=False)
    assert train_gnn.build_graph_ops(cfg, data, cpu)[1].transpose is None
    monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0")
    g = train_gnn.build_graph_ops(cfg, data, cpu)[1]
    assert g.depth == 4 and g.transpose is not None
    assert g.transpose.slot_occ is not None and g.transpose.a_packed is not None
    assert train_gnn.build_graph_ops(cfg, data, cpu, training=False)[1].transpose is None
