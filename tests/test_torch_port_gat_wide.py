"""Port parity for GAT wider than one kernel launch (h*ch + 2h > 512
columns): the split of the packed rows into launches (gat_cuda.width_tiles
and the *_tiled functions), driven here by the plain versions at a small
width limit, against the untiled plain versions in both gauges for the
forward, the one-sweep backward and the two sweeps; the packed training
step through those tiled launches against autograd through the plain
formulation; and a GAT of 4 heads of 128 against the JAX model on the same
weights. The CUDA launches are held against the plain versions at (4, 128)
and (1, 600) in tests/test_torch_port_cuda.py.

Tolerances: the tiled forward against the untiled one rtol 1e-5, atol 1e-6
(the same f32 sums; a narrower product may block them otherwise); the
backwards rtol 1e-5, atol 1e-5 (a head's dot xp_j . A_i summed by column
tiles and then added); the packed step's logits rtol 1e-4, atol 1e-5 and
parameter gradients rtol 5e-4, atol 5e-5, and the logits against the JAX
model rtol 1e-4, atol 1e-5 (as tests/test_torch_port_gat.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu_torch.kernels import bsda as port_bsda
from elliptic_gnn_tpu_torch.kernels import gat_bwd, gat_cuda, packed_gat
from elliptic_gnn_tpu_torch.models import build_model
from elliptic_gnn_tpu_torch.models.convert import params_from_jax
from tests.test_torch_port_tables import port_graph

N = 128 * 6
SLOPE = 0.2
FWD = dict(rtol=1e-5, atol=1e-6)
SWEEP = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=5e-4, atol=5e-5)
# (h, ch, width limit): groups of one head; groups of two and one; column
# tiles in runs of 4; two heads each in an uneven pair of column tiles
CASES = [(4, 8, 16), (3, 5, 16), (1, 20, 8), (2, 9, 8)]


def _edges():
    rng = np.random.default_rng(5)
    ei, _ = port_graph(N, 8, 1.5, seed=5, n_far=30)
    return np.concatenate([ei, ei[:, rng.integers(0, ei.shape[1], 30)]], axis=1)


@pytest.fixture(scope="module")
def graph():
    g = port_bsda.build_bsda_for_kind(_edges(), N, "gat", depth=2, transpose=True)
    assert g.residual is not None and int(g.a.max()) > 1
    return g


def _inputs(g, h, ch, normalized, seed=11):
    rng = np.random.default_rng(seed)
    w = gat_cuda.payload_width(h, ch)
    pay = torch.from_numpy((0.5 * rng.standard_normal((N, w))).astype(np.float32))
    gbar = torch.from_numpy(rng.standard_normal((N, w)).astype(np.float32))
    return pay, gbar, gat_cuda.gat_fwd_plain(g, pay, h, ch, SLOPE, normalized)


def _plain_launches(g):
    """The plain versions behind the *_tiled functions' launch arguments."""
    def dst(gbar, pay, out_k, h, ch, normalized, ct):
        d, g2 = gat_cuda.gat_bwd_dst_fused_plain(g, gbar, pay, out_k, h, ch, SLOPE,
                                                 normalized)
        if ct is not None:
            ct[:, h * ch + h:] = d[:, h * ch + h:]
            d = ct
        return d, g2

    def src(pay, g2, h, ch, ct):
        d = gat_cuda.gat_bwd_src_plain(g.transpose, pay, g2, h, ch, SLOPE)
        if ct is not None:
            ct[:, : h * ch + h] = d[:, : h * ch + h]
            d = ct
        return d

    return dict(
        fwd=lambda pay, h, ch, nm: gat_cuda.gat_fwd_plain(g, pay, h, ch, SLOPE, nm),
        bwd=lambda gb, pay, o, h, ch, nm: gat_cuda.gat_bwd_plain(g, gb, pay, o, h, ch,
                                                                 SLOPE, nm),
        dst=dst, src=src)


@pytest.mark.parametrize("h,ch,limit", CASES + [(4, 128, 512), (1, 600, 512),
                                                (170, 1, 512), (8, 62, 512)])
def test_width_tiles_cover_every_column_once(h, ch, limit):
    tiles = gat_cuda.width_tiles(h, ch, limit)
    seen = torch.zeros(h * ch, dtype=torch.int64)
    for tile in tiles:
        _, k, _, c = tile
        assert gat_cuda.payload_width(k, c) <= limit
        idx = gat_cuda._tile_index(h, ch, tile, 2, "cpu")
        seen[idx[: k * c]] += 1
        if c < ch and ch % 4 == 0:
            assert c % 4 == 0  # whole runs of 4 for the kernels' 16-byte path
    assert bool((seen == 1).all())
    assert len(tiles) == 1 or gat_cuda.payload_width(h, ch) > limit


@pytest.mark.parametrize("h,ch,limit", CASES)
@pytest.mark.parametrize("normalize", [False, True])
def test_tiled_forward_equals_untiled(graph, h, ch, limit, normalize):
    pay, _, want = _inputs(graph, h, ch, normalize)
    got = gat_cuda.gat_fwd_tiled(_plain_launches(graph)["fwd"], pay, h, ch, normalize,
                                 max_width=limit)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)


@pytest.mark.parametrize("h,ch,limit", CASES)
@pytest.mark.parametrize("normalized", [False, True])
def test_tiled_one_sweep_equals_untiled(graph, h, ch, limit, normalized):
    pay, gbar, out_k = _inputs(graph, h, ch, normalized)
    got = gat_cuda.gat_bwd_tiled(_plain_launches(graph)["bwd"], gbar, pay, out_k, h, ch,
                                 normalized, max_width=limit)
    want = gat_cuda.gat_bwd_plain(graph, gbar, pay, out_k, h, ch, SLOPE, normalized)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SWEEP)


@pytest.mark.parametrize("h,ch,limit", CASES)
@pytest.mark.parametrize("normalized", [False, True])
def test_tiled_two_sweep_equals_untiled(graph, h, ch, limit, normalized):
    """The destination sweep in tiles gives grad_payload's G2 and the d
    a_dst columns; the source sweep in tiles over that G2 the rest; their
    sum the untiled two-sweep backward's, and twice the same bits."""
    pay, gbar, out_k = _inputs(graph, h, ch, normalized)
    launch = _plain_launches(graph)
    runs = []
    for _ in range(2):
        ct, g2 = gat_cuda.gat_bwd_dst_tiled(launch["dst"], gbar, pay, out_k, h, ch,
                                            normalized, max_width=limit)
        ct = gat_cuda.gat_bwd_src_tiled(launch["src"], pay, g2, h, ch, ct=ct,
                                        max_width=limit)
        runs.append((ct, g2))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    ct, g2 = runs[0]
    np.testing.assert_allclose(
        g2.numpy(), gat_bwd.grad_payload(gbar, pay, out_k, h, ch, normalized).numpy(),
        rtol=1e-6, atol=0)
    want = gat_cuda.gat_bwd_two_sweep(graph, gbar, pay, out_k, h, ch, SLOPE, normalized)
    np.testing.assert_allclose(ct.numpy(), want.numpy(), **SWEEP)


@pytest.mark.parametrize("cfg,limit", [
    ({"hidden_dim": 64, "heads": 4}, 40),   # (4, 16): two launches of two heads
    ({"hidden_dim": 48, "heads": 1}, 40),   # (1, 48): two column tiles of 24
])
@pytest.mark.parametrize("two_sweep", [False, True])
def test_packed_step_through_tiled_launches(graph, monkeypatch, cfg, limit, two_sweep):
    """The packed training step (forward, spill merge, backward) with every
    GAT launch split at `limit` columns, the plain versions behind it:
    logits and parameter gradients against autograd through forward_plain."""
    launch = _plain_launches(graph)

    def fwd(g, pay, h, ch, slope, normalize=False, dst_row0=0):
        return gat_cuda.gat_fwd_tiled(launch["fwd"], pay, h, ch, normalize, limit)

    def bwd(g, gbar, pay, out_k, h, ch, slope, normalized, dst_row0=0):
        return gat_cuda.gat_bwd_tiled(launch["bwd"], gbar, pay, out_k, h, ch,
                                      normalized, limit)

    def two(g, gbar, pay, out_k, h, ch, slope, normalized, **rect):
        ct, g2 = gat_cuda.gat_bwd_dst_tiled(launch["dst"], gbar, pay, out_k, h, ch,
                                            normalized, max_width=limit)
        return gat_cuda.gat_bwd_src_tiled(launch["src"], pay, g2, h, ch, ct, limit)

    monkeypatch.setattr(packed_gat, "gat_fwd", fwd)
    monkeypatch.setattr(packed_gat, "gat_bwd", bwd)
    monkeypatch.setattr(packed_gat, "gat_bwd_two_sweep", two)
    monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0" if two_sweep else "1")
    model = build_model("gat", 12, dict(cfg, layers=2, dropout=0.0),
                        generator=torch.Generator().manual_seed(2)).train()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((N, 12)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, N))
    params = [dict(w=l.w, a_src=l.a_src, a_dst=l.a_dst, b=l.b) for l in model.layers]
    logits = packed_gat.packed_gat_train_forward(params, x, graph)
    torch.nn.functional.cross_entropy(logits, y).backward()
    got = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    want_logits = model.forward_plain(x, graph)
    torch.nn.functional.cross_entropy(want_logits, y).backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits.detach().numpy(),
                               **LOGITS)
    for a, p in zip(got, model.parameters()):
        np.testing.assert_allclose(a.numpy(), p.grad.numpy(), **BWD)


def test_wide_gat_matches_jax_model(graph):
    """A GAT of 4 heads of 128 (h*ch + 2h = 520 columns): the port's CPU
    path (forward_plain) and the packed pipeline through the plain versions
    against the JAX model's logits on the same weights."""
    cfg = {"hidden_dim": 512, "layers": 2, "heads": 4, "dropout": 0.0}
    assert gat_cuda.payload_width(4, 128) > gat_cuda.MAX_WIDTH
    f_in = 10
    mj = jax_build_model("gat", f_in, cfg)
    params, state = mj.init(jax.random.PRNGKey(3))
    mp = build_model("gat", f_in, cfg)
    params_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state), mp)
    x = np.random.default_rng(8).standard_normal((N, f_in)).astype(np.float32)
    gj = jax_bsda.build_bsda_for_kind(_edges(), N, "gat", depth=2, transpose=False)
    want, _ = mj.apply(params, state, jnp.asarray(x), gj, training=False)
    mp.eval()
    with torch.no_grad():
        got = mp(torch.from_numpy(x), graph)
    packed = packed_gat.packed_gat_forward(
        [dict(w=l.w, a_src=l.a_src, a_dst=l.a_dst, b=l.b) for l in mp.layers],
        torch.from_numpy(x), graph)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(packed.numpy(), np.asarray(want), **LOGITS)
