"""The port's CUDA kernels (BSDA SpMM, flash-GAT forward, one-sweep backward
and the two-sweep backward pair, whose destination sweep writes the grad
payload G2) against their plain PyTorch versions, on the card, at the
widths one launch takes and wider (split into launches); and the trainer's
K-epoch loop, its epoch captured as a CUDA graph and replayed, against the
serial loop (K = 4 on a 6,000-node graph: per-epoch loss and val PR-AUC
within 1e-4, the stop epoch, two-sweep GAT runs bit-equal, a failed capture
raises); the mesh paths' rectangular launches (BSDA and the four GAT
kernels of every rank and shard against their plain versions and the whole
graph) and their trainers as one NCCL rank against the single-device K
loop. Every test here needs
an NVIDIA GPU and skips without one; this file imports nothing of JAX so
that it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: f32 rtol 1e-5, atol 1e-5 (the same f32 products summed in
another order); bf16 results rtol 1/64, atol 1e-3 (two bf16 ulps: the f32
sums may round to neighbouring bf16 values); full SpMM and model outputs
under amp rtol 2e-2, atol 2e-2. GAT (f32): forward rtol 1e-4, atol 1e-5 on
val and m + log s (expf on the card against torch.exp, sums in another
order); backward and parameter gradients rtol 5e-4, atol 5e-5 (atomics in
the one-sweep backward; the two sweeps are held to the same tolerance
against their plain versions and must repeat bit for bit).
"""
import dataclasses

import numpy as np
import pytest
import torch

from elliptic_gnn_tpu_torch.graph import synthetic
from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges
from elliptic_gnn_tpu_torch.kernels import bsda, gat_cuda
from elliptic_gnn_tpu_torch.models import build_model

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1 / 64, atol=1e-3)
AMP = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(n=20000, seed=0):
    """Elliptic-like synthetic graph, symmetrized and BFS-renumbered, with
    the main path's tables (sage, int8, depth 3, transpose)."""
    data = symmetrize_edges(synthetic.generate(
        num_nodes=n, num_features=4, num_timesteps=8, seed=seed))
    rank = bsda.bfs_order(data.edge_index, n, data.timestep)
    data = data.renumber(rank)
    g = bsda.build_bsda_for_kind(data.edge_index, n, "sage", depth=3,
                                 a_dtype="int8", transpose=True)
    return data, g


def _unpacked(g):
    g1 = dataclasses.replace(g, a_packed=None, a_pack=1)
    if g.transpose is not None:
        g1 = dataclasses.replace(g1, transpose=_unpacked(g.transpose))
    return g1


def _randn(shape, seed, device, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [4, 1])
@pytest.mark.parametrize("f,dtype", [(168, torch.float32), (168, torch.bfloat16),
                                     (64, torch.bfloat16), (40, torch.float32)])
def test_kernel_matches_plain(cuda, pack, f, dtype):
    from elliptic_gnn_tpu_torch.kernels.bsda_spmm_cuda import bsda_dense_cuda

    _, g = _graph()
    g = (g if pack == 4 else _unpacked(g)).to(cuda)
    x = _randn((g.num_nodes, f), 1, cuda, dtype)
    tol = F32 if dtype == torch.float32 else BF16
    for table in (g, g.transpose):  # dst scale; src scale
        got = bsda_dense_cuda(table, x)
        torch.cuda.synchronize()
        want = bsda.bsda_dense_plain(table, x)
        assert got.dtype == dtype and got.shape == want.shape
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_spmm_fwd_bwd_matches_plain(cuda, amp):
    """Full aggregation (kernel + spill) and its gradient through the
    transpose tables, against the plain version on the same card."""
    from elliptic_gnn_tpu_torch.kernels import spmm

    _, g = _graph()
    g = g.to(cuda)
    cdt = torch.bfloat16 if amp else None
    x = _randn((g.num_nodes, 96), 2, cuda)
    ct = _randn((g.num_nodes, 96), 3, cuda)
    outs = []
    for fn in (spmm, bsda.bsda_spmm):
        xr = x.clone().requires_grad_(True)
        out = fn(g, xr, compute_dtype=cdt)
        (out * ct).sum().backward()
        outs.append((out.detach().cpu().numpy(), xr.grad.cpu().numpy()))
    tol = AMP if amp else F32
    np.testing.assert_allclose(outs[0][0], outs[1][0], **tol)
    np.testing.assert_allclose(outs[0][1], outs[1][1], **tol)


@pytest.mark.cuda
def test_model_on_cuda_matches_cpu(cuda):
    """SAGE-ResBN logits (eval) with amp on the card (kernel) against the
    same weights on the CPU (plain version)."""
    data, g = _graph(6000, seed=4)
    cfg = {"hidden_dim": 64, "layers": 3, "dropout": 0.0, "amp": True,
           "time_embed_dim": 2, "time_embed_type": "sin"}
    x = _randn((data.num_nodes, 166), 5, "cpu")
    t = torch.from_numpy(data.timestep.astype(np.int32))
    model = build_model("sage_resbn", 166, cfg,
                        generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        want = model(x, g, t).numpy()
        got = model.to(cuda)(x.to(cuda), g.to(cuda), t.to(cuda)).cpu().numpy()
    np.testing.assert_allclose(got, want, **AMP)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    from elliptic_gnn_tpu_torch.kernels.bsda_spmm_cuda import bsda_dense_cuda

    _, g = _graph(3000)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bsda_dense_cuda(g, torch.zeros((3000, 8)))
    g_float = bsda.build_bsda_for_kind(
        np.zeros((2, 0), np.int64), 3000, "sage", depth=3).to(cuda)
    with pytest.raises(ValueError, match="integer multiplicity"):
        bsda_dense_cuda(g_float, torch.zeros((3000, 8), device=cuda))
    with pytest.raises(ValueError, match="tables on"):
        bsda_dense_cuda(g, torch.zeros((3000, 8), device=cuda))


# ---------------- flash-GAT kernels ----------------

GAT_FWD = dict(rtol=1e-4, atol=1e-5)
GAT_BWD = dict(rtol=5e-4, atol=5e-5)


def _gat_graph(n=20000, seed=0, depth=4, far=200, pack4=True):
    """Directed, self-looped GAT tables of an Elliptic-like synthetic
    graph, with far edges (a spill) and duplicates (multiplicity > 1)."""
    data = synthetic.generate(num_nodes=n, num_features=4, num_timesteps=8, seed=seed)
    rank = bsda.bfs_order(data.edge_index, n, data.timestep)
    data = data.renumber(rank)
    rng = np.random.default_rng(seed)
    ei = data.edge_index
    ei = np.concatenate([ei, rng.integers(0, n, (2, far)),
                         ei[:, rng.integers(0, ei.shape[1], 300)]], axis=1)
    g = bsda.build_bsda_for_kind(ei, n, "gat", depth=depth, transpose=False)
    assert g.residual is not None and g.a_pack > 1
    return g if pack4 else dataclasses.replace(g, a_packed=None, a_pack=1)


def _gauge_free(out, h, ch, normalized):
    hc = h * ch
    acc = out[:, :hc].reshape(-1, h, ch)
    m, s = out[:, hc: hc + h], out[:, hc + h: hc + 2 * h]
    val = acc if normalized else acc / s.clamp_min(1e-16)[..., None]
    return val, m + torch.log(s.clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("h,ch", [(4, 8), (1, 2), (2, 16), (3, 5), (8, 40)])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("pack4", [True, False])
def test_gat_forward_kernel_matches_plain(cuda, h, ch, normalize, pack4):
    g = _gat_graph(pack4=pack4).to(cuda)
    pay = _randn((g.num_chunks * 128, gat_cuda.payload_width(h, ch)), 1, cuda)
    want = gat_cuda.gat_fwd_plain(g, pay, h, ch, 0.2, normalize)
    for gated in (True, False):
        got = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalize, gated=gated)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        for a, b in zip(_gauge_free(got, h, ch, normalize),
                        _gauge_free(want, h, ch, normalize)):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **GAT_FWD)
    # rows past the last node have no edge: s = 0, m = -1e30, acc = 0
    tail = got[g.num_nodes:]
    hc = h * ch
    assert (tail[:, :hc] == 0).all() and (tail[:, hc + h:] == 0).all()
    assert (tail[:, hc: hc + h] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("h,ch", [(4, 8), (1, 2), (2, 16), (3, 5), (8, 40)])
@pytest.mark.parametrize("normalized", [False, True])
def test_gat_backward_kernel_matches_plain(cuda, h, ch, normalized):
    g = _gat_graph().to(cuda)
    shape = (g.num_chunks * 128, gat_cuda.payload_width(h, ch))
    pay = _randn(shape, 2, cuda)
    gbar = _randn(shape, 3, cuda)
    out_k = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalized)
    got = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    torch.cuda.synchronize()
    want = gat_cuda.gat_bwd_plain(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GAT_BWD)


@pytest.mark.cuda
def test_gat_model_on_cuda_matches_cpu(cuda):
    """GAT logits and parameter gradients on the card (flash kernels, spill
    merge) against the same weights on the CPU (per-layer plain
    formulation, autograd), and against that plain formulation called
    directly on the card (forward_plain)."""
    g = _gat_graph(6000, seed=4)
    cfg = {"hidden_dim": 32, "layers": 2, "heads": 4, "dropout": 0.0}
    x = _randn((g.num_nodes, 30), 5, "cpu")
    y = torch.from_numpy(np.random.default_rng(6).integers(0, 2, g.num_nodes))
    results = []
    for device, plain in (("cpu", False), (cuda, False), (cuda, True)):
        model = build_model("gat", 30, cfg,
                            generator=torch.Generator().manual_seed(0)).to(device)
        run = model.forward_plain if plain else model
        gat_cuda.reset_launches()
        model.train()
        logits = run(x.to(device), g.to(device))
        torch.nn.functional.cross_entropy(logits, y.to(device)).backward()
        kernel_path = device != "cpu" and not plain
        assert gat_cuda.launches == {
            "gat_fwd": int(kernel_path), "gat_fwd_gated": int(kernel_path),
            "gat_bwd": 2 * int(kernel_path), "gat_bwd_dst": 0, "gat_bwd_src": 0}
        model.eval()
        with torch.no_grad():
            ev = run(x.to(device), g.to(device))
        results.append((logits.detach().cpu().numpy(), ev.cpu().numpy(),
                        [p.grad.cpu().numpy() for p in model.parameters()]))
    for got in results[1:]:
        np.testing.assert_allclose(got[0], results[0][0], **GAT_FWD)
        np.testing.assert_allclose(got[1], results[0][1], **GAT_FWD)
        for a, b in zip(got[2], results[0][2]):
            np.testing.assert_allclose(a, b, **GAT_BWD)


@pytest.mark.cuda
def test_gat_kernels_reject_what_they_do_not_take(cuda):
    g = _gat_graph(3000)
    pay = torch.zeros((g.num_chunks * 128, 40))
    with pytest.raises(ValueError, match="CUDA tensor"):
        gat_cuda.gat_fwd_cuda(g, pay, 4, 8)
    with pytest.raises(ValueError, match="tables on"):
        gat_cuda.gat_fwd_cuda(g, pay.to(cuda), 4, 8)
    with pytest.raises(ValueError, match="contiguous float32"):
        gat_cuda.gat_fwd_cuda(g.to(cuda), pay.to(cuda)[:, :36], 4, 8)
    with pytest.raises(ValueError, match=r"\[N_pad, 640\]"):
        gat_cuda.gat_fwd_cuda(g.to(cuda), pay.to(cuda), 64, 8)


# ---------------- the two-sweep backward ----------------

def _two_sweep_inputs(cuda, h, ch, normalized, pack4=True):
    g = _gat_graph(pack4=pack4)
    t = bsda.gat_block_transpose(g)
    if not pack4:
        t = dataclasses.replace(t, a_packed=None, a_pack=1)
    g = dataclasses.replace(g, transpose=t).to(cuda)
    shape = (g.num_chunks * 128, gat_cuda.payload_width(h, ch))
    pay, gbar = _randn(shape, 2, cuda), _randn(shape, 3, cuda)
    out_k = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalized)
    return g, pay, gbar, out_k


@pytest.mark.cuda
@pytest.mark.parametrize("h,ch", [(4, 8), (1, 2), (2, 16), (3, 5), (8, 40)])
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("pack4", [True, False])
def test_gat_sweep_kernels_match_plain(cuda, h, ch, normalized, pack4):
    """Each sweep against its plain version: the destination sweep's d a_dst
    and G2 against grad_payload and gat_bwd_dst_plain, two launches bit for
    bit; the source sweep on the kernel's G2; each writing only its own
    columns; their sum against the one-sweep kernel."""
    g, pay, gbar, out_k = _two_sweep_inputs(cuda, h, ch, normalized, pack4)
    hc = h * ch
    d_dst, g2 = gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    again, g2_again = gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    d_src = gat_cuda.gat_bwd_src_cuda(g.transpose, pay, g2, h, ch, 0.2)
    torch.cuda.synchronize()
    assert torch.equal(d_dst, again) and torch.equal(g2, g2_again)
    assert not d_dst[:, : hc + h].any() and not d_src[:, hc + h:].any()
    want_dst, want_g2 = gat_cuda.gat_bwd_dst_fused_plain(g, gbar, pay, out_k, h, ch, 0.2,
                                                         normalized)
    np.testing.assert_allclose(d_dst.cpu().numpy(), want_dst.cpu().numpy(), **GAT_BWD)
    np.testing.assert_allclose(g2.cpu().numpy(), want_g2.cpu().numpy(), **GAT_BWD)
    np.testing.assert_allclose(
        d_src.cpu().numpy(),
        gat_cuda.gat_bwd_src_plain(g.transpose, pay, g2, h, ch, 0.2).cpu().numpy(),
        **GAT_BWD)
    one = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    np.testing.assert_allclose((d_dst + d_src).cpu().numpy(), one.cpu().numpy(),
                               **GAT_BWD)


@pytest.mark.cuda
@pytest.mark.parametrize("h,ch", [(4, 8), (1, 2), (8, 40)])
def test_gat_two_sweep_repeats_bit_for_bit(cuda, h, ch):
    """Two runs of the two-sweep backward give the same bits, in every
    column, and it launches each sweep once and the one-sweep kernel never."""
    g, pay, gbar, out_k = _two_sweep_inputs(cuda, h, ch, True)
    gat_cuda.reset_launches()
    first = gat_cuda.gat_bwd_two_sweep(g, gbar, pay, out_k, h, ch, 0.2, True)
    assert gat_cuda.launches == {"gat_fwd": 0, "gat_fwd_gated": 0, "gat_bwd": 0,
                                 "gat_bwd_dst": 1, "gat_bwd_src": 1}
    for _ in range(3):
        again = gat_cuda.gat_bwd_two_sweep(g, gbar, pay, out_k, h, ch, 0.2, True)
        assert torch.equal(first, again)
    want = gat_cuda.gat_bwd_plain(g, gbar, pay, out_k, h, ch, 0.2, True)
    np.testing.assert_allclose(first.cpu().numpy(), want.cpu().numpy(), **GAT_BWD)


@pytest.mark.cuda
def test_gat_model_two_sweep_on_cuda(cuda, monkeypatch):
    """The GAT training step on the card with the two-sweep backward
    chosen: the sweeps' launches, gradients equal bit for bit on a repeat
    and within tolerance of the one-sweep step; without transpose tables it
    raises instead of sliding back."""
    g = _gat_graph(6000, seed=4)
    g_t = dataclasses.replace(g, transpose=bsda.gat_block_transpose(g)).to(cuda)
    cfg = {"hidden_dim": 32, "layers": 2, "heads": 4, "dropout": 0.0}
    x = _randn((g.num_nodes, 30), 5, cuda)
    y = torch.from_numpy(np.random.default_rng(6).integers(0, 2, g.num_nodes)).to(cuda)
    model = build_model("gat", 30, cfg,
                        generator=torch.Generator().manual_seed(0)).to(cuda).train()

    def step(tables):
        model.zero_grad(set_to_none=True)
        gat_cuda.reset_launches()
        torch.nn.functional.cross_entropy(model(x, tables), y).backward()
        return [p.grad.clone() for p in model.parameters()], dict(gat_cuda.launches)

    monkeypatch.delenv("EGNN_GAT_ONE_SWEEP", raising=False)
    one, counts = step(g_t)
    assert counts["gat_bwd"] == 2 and counts["gat_bwd_dst"] == counts["gat_bwd_src"] == 0
    monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0")
    two, counts = step(g_t)
    assert counts == {"gat_fwd": 1, "gat_fwd_gated": 1, "gat_bwd": 0,
                      "gat_bwd_dst": 2, "gat_bwd_src": 2}
    again, _ = step(g_t)
    for a, b, c in zip(two, again, one):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), **GAT_BWD)
    with pytest.raises(ValueError, match="transpose tables"):
        step(g.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [96, 120])
def test_gat_dst_sweep_above_depth_64(cuda, depth):
    """The destination sweep takes the edge list's depths (it took 64 at most
    while it staged the planes): tables of `depth` slots, against the plain
    version, two launches bit for bit. 2,000 random far edges fill up to 36
    slots of a chunk."""
    n = 6000
    data = synthetic.generate(num_nodes=n, num_features=4, num_timesteps=8, seed=2)
    data = data.renumber(bsda.bfs_order(data.edge_index, n, data.timestep))
    ei = np.concatenate([data.edge_index,
                         np.random.default_rng(2).integers(0, n, (2, 2000))], axis=1)
    g = bsda.build_bsda_for_kind(ei, n, "gat", depth=depth, transpose=False).to(cuda)
    assert g.depth == depth > 64 and int(g.slot_occ.max()) > 16
    shape = (g.num_chunks * 128, gat_cuda.payload_width(4, 8))
    pay, gbar = _randn(shape, 4, cuda), _randn(shape, 5, cuda)
    out_k = gat_cuda.gat_fwd_cuda(g, pay, 4, 8, 0.2, True)
    d_dst, g2 = gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, 4, 8, 0.2, True)
    again, _ = gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, 4, 8, 0.2, True)
    torch.cuda.synchronize()
    assert torch.equal(d_dst, again)
    want_dst, want_g2 = gat_cuda.gat_bwd_dst_fused_plain(g, gbar, pay, out_k, 4, 8, 0.2, True)
    np.testing.assert_allclose(d_dst.cpu().numpy(), want_dst.cpu().numpy(), **GAT_BWD)
    np.testing.assert_allclose(g2.cpu().numpy(), want_g2.cpu().numpy(), **GAT_BWD)


# ---------------- GAT wider than one launch ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("h,ch,n_launches", [(4, 128, 2), (1, 600, 2)])
@pytest.mark.parametrize("normalized", [False, True])
def test_gat_wide_kernels_match_plain(cuda, h, ch, n_launches, normalized):
    """h*ch + 2h > 512: each of the four kernels in launches of at most 512
    columns (two groups of two heads; two column tiles of one head) against
    its plain version; the two sweeps bit for bit on a repeat."""
    g = _gat_graph(6000, seed=4)
    g = dataclasses.replace(g, transpose=bsda.gat_block_transpose(g)).to(cuda)
    hc = h * ch
    assert gat_cuda.payload_width(h, ch) > gat_cuda.MAX_WIDTH
    shape = (g.num_chunks * 128, gat_cuda.payload_width(h, ch))
    pay, gbar = _randn(shape, 6, cuda), _randn(shape, 7, cuda)
    gat_cuda.reset_launches()
    out_k = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalized)
    one = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    two = gat_cuda.gat_bwd_two_sweep(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    d_dst, g2 = gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    torch.cuda.synchronize()
    assert gat_cuda.launches == {
        "gat_fwd": n_launches * int(h == 1), "gat_fwd_gated": n_launches * int(h > 1),
        "gat_bwd": n_launches, "gat_bwd_dst": 2 * n_launches, "gat_bwd_src": n_launches}
    assert torch.equal(two, gat_cuda.gat_bwd_two_sweep(g, gbar, pay, out_k, h, ch, 0.2,
                                                       normalized))
    want = gat_cuda.gat_fwd_plain(g, pay, h, ch, 0.2, normalized)
    for a, b in zip(_gauge_free(out_k, h, ch, normalized),
                    _gauge_free(want, h, ch, normalized)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **GAT_FWD)
    want = gat_cuda.gat_bwd_plain(g, gbar, pay, out_k, h, ch, 0.2, normalized).cpu().numpy()
    np.testing.assert_allclose(one.cpu().numpy(), want, **GAT_BWD)
    np.testing.assert_allclose(two.cpu().numpy(), want, **GAT_BWD)
    want_dst, want_g2 = gat_cuda.gat_bwd_dst_fused_plain(g, gbar, pay, out_k, h, ch, 0.2,
                                                         normalized)
    np.testing.assert_allclose(d_dst.cpu().numpy(), want_dst.cpu().numpy(), **GAT_BWD)
    np.testing.assert_allclose(g2.cpu().numpy(), want_g2.cpu().numpy(), **GAT_BWD)
    src = gat_cuda.gat_bwd_src_cuda(g.transpose, pay, g2, h, ch, 0.2)
    np.testing.assert_allclose(
        src[:, : hc + h].cpu().numpy(),
        gat_cuda.gat_bwd_src_plain(g.transpose, pay, g2, h, ch, 0.2)[:, : hc + h].cpu().numpy(),
        **GAT_BWD)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,heads", [(512, 4), (600, 1)])
def test_wide_gat_model_on_cuda_matches_cpu(cuda, monkeypatch, hidden, heads):
    """A GAT whose hidden layer is wider than one launch trains and scores
    on the card through the kernels (launch counts), with both backwards:
    logits and parameter gradients against the same weights on the CPU."""
    g = _gat_graph(6000, seed=4)
    g_t = dataclasses.replace(g, transpose=bsda.gat_block_transpose(g))
    cfg = {"hidden_dim": hidden, "layers": 2, "heads": heads, "dropout": 0.0}
    x = _randn((g.num_nodes, 30), 5, "cpu")
    y = torch.from_numpy(np.random.default_rng(6).integers(0, 2, g.num_nodes))
    results = []
    for device, one_sweep in (("cpu", "1"), (cuda, "1"), (cuda, "0")):
        monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", one_sweep)
        model = build_model("gat", 30, cfg,
                            generator=torch.Generator().manual_seed(0)).to(device).train()
        gat_cuda.reset_launches()
        logits = model(x.to(device), g_t.to(device))
        torch.nn.functional.cross_entropy(logits, y.to(device)).backward()
        if device != "cpu":
            bwd = ("gat_bwd",) if one_sweep == "1" else ("gat_bwd_dst", "gat_bwd_src")
            assert all(gat_cuda.launches[k] >= 3 for k in bwd)  # 2 tiles + final layer
            assert gat_cuda.launches["gat_fwd"] + gat_cuda.launches["gat_fwd_gated"] >= 3
        model.eval()
        with torch.no_grad():
            ev = model(x.to(device), g_t.to(device))
        results.append((logits.detach().cpu().numpy(), ev.cpu().numpy(),
                        [p.grad.cpu().numpy() for p in model.parameters()]))
    for got in results[1:]:
        np.testing.assert_allclose(got[0], results[0][0], **GAT_FWD)
        np.testing.assert_allclose(got[1], results[0][1], **GAT_FWD)
        for a, b in zip(got[2], results[0][2]):
            np.testing.assert_allclose(a, b, **GAT_BWD)


# ---------------- GCN and SAGE through the BSDA kernel ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("f,dtype", [(2, torch.bfloat16), (2, torch.float32),
                                     (128, torch.bfloat16)])
def test_gcn_tables_both_scales_match_plain(cuda, f, dtype):
    """GCN's tables carry dst_scale and src_scale together, and its last
    layer aggregates the F = 2 logits: kernel against plain version on the
    forward and the transpose tables."""
    from elliptic_gnn_tpu_torch.kernels.bsda_spmm_cuda import bsda_dense_cuda

    data, _ = _graph()
    g = bsda.build_bsda_for_kind(data.edge_index, data.num_nodes, "gcn", depth=3,
                                 a_dtype="int8", transpose=True).to(cuda)
    assert g.dst_scale is not None and g.src_scale is not None
    x = _randn((g.num_nodes, f), 1, cuda, dtype)
    for table in (g, g.transpose):
        got = bsda_dense_cuda(table, x)
        torch.cuda.synchronize()
        want = bsda.bsda_dense_plain(table, x)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gcn", "sage"])
@pytest.mark.parametrize("amp", [False, True])
def test_conv_stack_on_cuda_matches_cpu(cuda, arch, amp):
    """GCN and SAGE logits and parameter gradients on the card (BSDA kernel)
    against the same weights on the CPU (plain version)."""
    from elliptic_gnn_tpu_torch.kernels import bsda_spmm_cuda

    data, _ = _graph(6000, seed=4)
    g = bsda.build_bsda_for_kind(data.edge_index, data.num_nodes, arch, depth=3,
                                 a_dtype="int8", transpose=True)
    cfg = {"hidden_dim": 128, "layers": 3, "dropout": 0.0, "amp": amp}
    x = _randn((data.num_nodes, 167), 5, "cpu")
    y = torch.from_numpy(np.random.default_rng(6).integers(0, 2, data.num_nodes))
    results = []
    for device in ("cpu", cuda):
        model = build_model(arch, 167, cfg,
                            generator=torch.Generator().manual_seed(0)).to(device).train()
        bsda_spmm_cuda.reset_launches()
        logits = model(x.to(device), g.to(device))
        torch.nn.functional.cross_entropy(logits, y.to(device)).backward()
        # three layers forward, and backward on the transpose tables where
        # the aggregated tensor needs a gradient: not SAGE's first, the input
        kernel_launches = 6 if arch == "gcn" else 5
        assert sum(bsda_spmm_cuda.launches.values()) == (
            0 if device == "cpu" else kernel_launches)
        results.append((logits.detach().cpu().numpy(),
                        [p.grad.cpu().numpy() for p in model.parameters()]))
    tol = AMP if amp else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(results[1][0], results[0][0], **tol)
    for a, b in zip(results[1][1], results[0][1]):
        np.testing.assert_allclose(a, b, **tol)


# ---------------- the ragged edges of the edge-list kernels ----------------

def _hub_graph(kind, depth, packed, n=700, out_hub=False):
    """synthetic.hub_edges: chunk 1 holds thousands of dense edges (several
    edge lists, many gather batches, a row of 300 sources), chunk 3 none;
    700 nodes are no multiple of 128. Bit-packed (pack 2) or int8 planes.
    `out_hub`: chunk 1 is also the source of thousands (its transpose list
    is taken in several groups), its row 9 of 300."""
    g = bsda.build_bsda_for_kind(synthetic.hub_edges(n, seed=11, out_hub=out_hub), n,
                                 kind, depth=depth, a_dtype="int8", transpose=True)
    assert int((g.a[1] != 0).sum()) > 2048 and g.a_pack > 1
    return g if packed else _unpacked(g)


def _assert_spmm_kernel(g, x, tol):
    from elliptic_gnn_tpu_torch.kernels.bsda_spmm_cuda import bsda_dense_cuda

    for table in (g, g.transpose):
        got = bsda_dense_cuda(table, x)
        again = bsda_dense_cuda(table, x)
        torch.cuda.synchronize()
        want = bsda.bsda_dense_plain(table, x)
        assert got.dtype == x.dtype and got.shape == want.shape
        assert torch.equal(got, again)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [4, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 2, 3, 63, 65, 167, 200])
def test_spmm_kernel_ragged_widths(cuda, f, dtype, pack):
    """Widths that are no multiple of a tile, a vector or a copy, on forward
    and transpose tables; two launches give the same bits."""
    _, g = _graph()
    assert g.num_nodes % 128 != 0 and g.a_pack == 4
    g = (g if pack == 4 else _unpacked(g)).to(cuda)
    x = _randn((g.num_nodes, f), f, cuda, dtype)
    _assert_spmm_kernel(g, x, F32 if dtype == torch.float32 else BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sage", "gcn"])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("f,dtype", [(2, torch.bfloat16), (65, torch.float32),
                                     (168, torch.bfloat16), (200, torch.float32)])
def test_spmm_kernel_hub_graph(cuda, kind, packed, f, dtype):
    g = _hub_graph(kind, 3, packed).to(cuda)
    x = _randn((g.num_nodes, f), f, cuda, dtype)
    _assert_spmm_kernel(g, x, F32 if dtype == torch.float32 else BF16)
    if kind == "sage":  # no edge into chunk 3: zeros, not what the buffer held
        from elliptic_gnn_tpu_torch.kernels.bsda_spmm_cuda import bsda_dense_cuda
        assert not bool(bsda_dense_cuda(g, x)[3 * 128: 4 * 128].any())


@pytest.mark.cuda
@pytest.mark.parametrize("h,ch", [(1, 1), (1, 2), (4, 8), (3, 5), (8, 62)])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("packed", [True, False])
def test_gat_forward_kernel_hub_graph(cuda, h, ch, normalize, packed):
    """The hub graph with one chunk emptied (occ 0), with the slot cover and
    without: rows of 300 edges straddle gather batches and are rescaled."""
    g = _hub_graph("gat", 4, packed)
    a, occ = g.a.clone(), g.slot_occ.clone()
    a[3], occ[3] = 0, 0
    a_packed = None
    if packed:
        a_packed = g.a_packed.clone()
        a_packed[3] = 0
    g = dataclasses.replace(g, a=a, a_packed=a_packed, slot_occ=occ,
                            transpose=None).to(cuda)
    pay = _randn((g.num_chunks * 128, gat_cuda.payload_width(h, ch)), h + ch, cuda)
    want = gat_cuda.gat_fwd_plain(g, pay, h, ch, 0.2, normalize)
    hc = h * ch
    for gated in (True, False):
        got = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalize, gated=gated)
        again = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalize, gated=gated)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, again)
        for p, q in zip(_gauge_free(got, h, ch, normalize),
                        _gauge_free(want, h, ch, normalize)):
            np.testing.assert_allclose(p.cpu().numpy(), q.cpu().numpy(), **GAT_FWD)
        empty = got[3 * 128: 4 * 128]
        assert (empty[:, :hc] == 0).all() and (empty[:, hc + h:] == 0).all()
        assert (empty[:, hc: hc + h] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("h,ch", [(1, 1), (1, 2), (4, 8), (2, 16), (3, 8), (1, 4),
                                  (3, 5), (8, 62), (1, 256)])
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("packed", [True, False])
def test_gat_backward_kernels_out_hub_graph(cuda, h, ch, normalized, packed):
    """The one-sweep backward and the two sweeps on the out-hub graph:
    hub rows and the out-hub source straddle gather batches, the transpose
    chunk 1 takes several edge lists; heads whose runs take xor shuffles
    ((1, 2), (4, 8), (2, 16)), none ((1, 1)) or the scratch row ((3, 5),
    (8, 62), (1, 256)); rows of 16-byte vector atomics and of scalar ones
    ((3, 8): 30 columns); G2 rows that are not 16-byte aligned, gathered
    by the 16-byte blocks that cover them (all but (4, 8), (8, 62) and
    (1, 256)); G2 rows stored 16 bytes a run (ch and h*ch + 3h multiples
    of 4: (4, 8)) or a float at a time. Against the plain versions;
    the two sweeps and the one-sweep d a_dst bit for bit on a repeat."""
    g = _hub_graph("gat", 4, packed, out_hub=True)
    assert int((g.transpose.a[1] != 0).sum()) > 2048
    g = g.to(cuda)
    hc = h * ch
    shape = (g.num_chunks * 128, gat_cuda.payload_width(h, ch))
    pay, gbar = _randn(shape, h + ch, cuda), _randn(shape, 2 * h + ch, cuda)
    out_k = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalized)
    got = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    again = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    dst, g2 = gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
    dst_again, g2_again = gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2,
                                                    normalized)
    src = gat_cuda.gat_bwd_src_cuda(g.transpose, pay, g2, h, ch, 0.2)
    src_again = gat_cuda.gat_bwd_src_cuda(g.transpose, pay, g2, h, ch, 0.2)
    torch.cuda.synchronize()
    assert torch.equal(got[:, hc + h:], again[:, hc + h:])
    assert torch.equal(dst, dst_again) and torch.equal(g2, g2_again)
    assert torch.equal(src, src_again) and not src[:, hc + h:].any()
    want_dst, want_g2 = gat_cuda.gat_bwd_dst_fused_plain(g, gbar, pay, out_k, h, ch, 0.2,
                                                         normalized)
    np.testing.assert_allclose(dst.cpu().numpy(), want_dst.cpu().numpy(), **GAT_BWD)
    np.testing.assert_allclose(g2.cpu().numpy(), want_g2.cpu().numpy(), **GAT_BWD)
    np.testing.assert_allclose(
        got.cpu().numpy(),
        gat_cuda.gat_bwd_plain(g, gbar, pay, out_k, h, ch, 0.2, normalized).cpu().numpy(),
        **GAT_BWD)
    np.testing.assert_allclose(
        src.cpu().numpy(),
        gat_cuda.gat_bwd_src_plain(g.transpose, pay, g2, h, ch, 0.2).cpu().numpy(),
        **GAT_BWD)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 3, 64, 167])
def test_spmm_kernel_takes_2_byte_aligned_views(cuda, f):
    """bf16 x that begins 2 bytes after a 4-byte boundary (a contiguous view
    into a larger buffer): no copy is aligned, the segments are shifted."""
    _, g = _graph()
    g = g.to(cuda)
    n = g.num_nodes
    flat = _randn((n * f + 1,), f, cuda, torch.bfloat16)
    x = flat[1:].view(n, f)
    assert x.is_contiguous() and x.data_ptr() % 4 == 2
    _assert_spmm_kernel(g, x, BF16)


# ---------------- the K-epoch loop as a replayed CUDA graph ----------------

def _kloop_run(tmp_path, processed, arch, k, run_name, **kw):
    """train_gnn.main on the card; returns (metrics, per-epoch loss, val
    PR-AUC, scores_test.npy)."""
    import csv

    from elliptic_gnn_tpu_torch.train import train_gnn

    cfg = {"run_name": run_name, "seed": 0, "processed_dir": processed,
           "output_root": str(tmp_path / "out"), "device": "cuda", "arch": arch,
           "hidden_dim": 32, "layers": 3 if arch == "sage_resbn" else 2,
           "heads": 4, "dropout": 0.2, "lr": 0.02, "weight_decay": 5e-5,
           "grad_clip": 1.0, "max_epochs": 20, "patience": 3, "amp": arch != "gat",
           "calibrate_temperature": True, "symmetrize_edges": arch != "gat",
           "time_embed_dim": 0 if arch == "gat" else 2, "time_embed_type": "sin",
           "use_time_scalar": arch == "gat", "max_timestep": 16,
           "train_window_k": 8, "topk": 20, "epochs_per_sync": k}
    cfg.update(kw)
    metrics = train_gnn.main(cfg)
    out = tmp_path / "out" / "gnn" / run_name
    with open(out / "training_log.csv") as f:
        rows = list(csv.DictReader(f))
    return (metrics, np.array([float(r["train_loss"]) for r in rows]),
            np.array([float(r["val_pr_auc"]) for r in rows]),
            np.load(out / "scores_test.npy"))


ELL_ARCH_CFG = {"hidden_dim": 32, "layers": 3, "heads": 4, "dropout": 0.0, "amp": True,
                "time_embed_dim": 2, "time_embed_type": "sin"}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["sage_resbn", "gcn", "sage", "gat"])
def test_model_on_ell_graph_cuda_matches_cpu(cuda, arch):
    """Each arch on an EllGraph (models.prepare_graph_ops, the explainer's
    encoding): the ELL gather on the card against the CPU, in f32 whatever
    `amp` says (rtol 1e-4, atol 1e-5 through three layers), and no
    hand-written kernel launched: an EllGraph is not a BSDA table."""
    from elliptic_gnn_tpu_torch.kernels import bsda_spmm_cuda
    from elliptic_gnn_tpu_torch.models import MODEL_GRAPH_KIND, prepare_graph_ops

    data, _ = _graph(3000, seed=6)
    g = prepare_graph_ops(data.edge_index, data.num_nodes, MODEL_GRAPH_KIND[arch])
    x = _randn((data.num_nodes, 16), 7, "cpu")
    t = torch.from_numpy(data.timestep.astype(np.int32))
    model = build_model(arch, 16, ELL_ARCH_CFG,
                        generator=torch.Generator().manual_seed(0)).eval()
    bsda_spmm_cuda.reset_launches()
    gat_cuda.reset_launches()
    with torch.no_grad():
        want = model(x, g, t).numpy()
        got = model.to(cuda)(x.to(cuda), g.to(cuda), t.to(cuda)).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert not any(bsda_spmm_cuda.launches.values()), bsda_spmm_cuda.launches
    assert not any(gat_cuda.launches.values()), gat_cuda.launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["sage_resbn", "gcn", "gat"])
def test_bsda_graph_on_cuda_still_runs_the_kernels(cuda, arch):
    """The dispatch by encoding leaves the main path alone: the trainer's
    BSDA tables on the card go through the hand-written kernels (launch
    counters > 0), with the CPU's plain version as reference (amp
    tolerance)."""
    from elliptic_gnn_tpu_torch.kernels import bsda_spmm_cuda
    from elliptic_gnn_tpu_torch.train.train_gnn import build_graph_ops

    data, _ = _graph(3000, seed=6)
    data, g = build_graph_ops({"arch": arch}, data, torch.device("cpu"), training=False)
    x = _randn((data.num_nodes, 16), 7, "cpu")
    t = torch.from_numpy(data.timestep.astype(np.int32))
    model = build_model(arch, 16, ELL_ARCH_CFG,
                        generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        want = model(x, g, t).numpy()
        bsda_spmm_cuda.reset_launches()
        gat_cuda.reset_launches()
        got = model.to(cuda)(x.to(cuda), g.to(cuda), t.to(cuda)).cpu().numpy()
    np.testing.assert_allclose(got, want, **AMP)
    if arch == "gat":
        assert gat_cuda.launches["gat_fwd"] > 0 and gat_cuda.launches["gat_fwd_gated"] > 0
    else:
        assert sum(bsda_spmm_cuda.launches.values()) > 0, bsda_spmm_cuda.launches


@pytest.fixture(scope="module")
def kloop_graph(tmp_path_factory):
    from elliptic_gnn_tpu_torch.graph import build_graph

    root = tmp_path_factory.mktemp("kloop")
    cfg = {"seed": 0, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
           "synthetic": True, "synthetic_nodes": 6000,
           "processed_dir": str(root / "processed")}
    build_graph.main(cfg)
    return cfg["processed_dir"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["sage_resbn", "gat"])
def test_k_loop_captured_matches_serial(cuda, tmp_path, kloop_graph, arch):
    """epochs_per_sync 4 (the epoch captured once, replayed) against the
    serial loop on the card, dropout on: per-epoch loss and val PR-AUC
    within 1e-4 (the one-sweep GAT backward sums with atomics), the same
    stop epoch inside a block, launches recorded in the captured epoch."""
    m1, loss1, pr1, _ = _kloop_run(tmp_path, kloop_graph, arch, 1, "serial")
    m4, loss4, pr4, _ = _kloop_run(tmp_path, kloop_graph, arch, 4, "k4")
    assert m4["epochs_run"] == m1["epochs_run"] == len(loss4)
    assert m1["epochs_run"] < 20 and m1["epochs_run"] % 4 != 0
    np.testing.assert_allclose(loss4, loss1, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pr4, pr1, rtol=0, atol=1e-4)
    blocks = -(-m4["epochs_run"] // 4)
    assert m4["graph_replays"] == 4 * blocks - 1
    kernels = ("gat_fwd_gated", "gat_fwd", "gat_bwd") if arch == "gat" else ("ring", "banded")
    assert all(m4["graph_launches"].get(name, 0) > 0 for name in kernels)


@pytest.mark.cuda
def test_k_loop_spans_on_the_card(cuda, tmp_path, kloop_graph):
    """The captured K loop's spans (utils/trace.py): one `loop.block` a
    block, `loop.capture` (its attrs the launches captured) under the first
    block's `loop.launch`, replay_ms and boundary_ms in metrics.json read
    from the block spans (a boundary from the second block on), and device
    boundaries that are positive."""
    from elliptic_gnn_tpu_torch.utils import trace

    trace.reset()
    m, loss, _, _ = _kloop_run(tmp_path, kloop_graph, "sage_resbn", 4, "spans",
                               patience=50, max_epochs=18)
    blocks = trace.spans("loop.block")
    assert [b.attrs["block"] for b in blocks] == list(range(5)) and len(loss) == 18
    assert m["replay_ms"] == [b.attrs["replay_ms"] for b in blocks]
    assert m["boundary_ms"] == [b.attrs["boundary_ms"] for b in blocks[1:]]
    assert "boundary_ms" not in blocks[0].attrs and all(v > 0 for v in m["boundary_ms"])
    (cap,) = trace.spans("loop.capture")
    launch = next(s for s in trace.spans("loop.launch") if s.parent == blocks[0].id)
    assert cap.parent == launch.id and cap.attrs == m["graph_launches"]
    assert trace.totals()["loop.capture"]["count"] == 1 and trace.counters()["loop_calls"] == 1


@pytest.mark.cuda
def test_k_loop_two_sweep_gat_bit_reproducible(cuda, tmp_path, kloop_graph, monkeypatch):
    """Two K-loop GAT runs with the two-sweep backward: the same bits."""
    monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0")
    runs = [_kloop_run(tmp_path, kloop_graph, "gat", 4, f"two_sweep_{i}") for i in range(2)]
    (ma, la, pa, sa), (mb, lb, pb, sb) = runs
    assert ma["graph_launches"].get("gat_bwd_dst", 0) > 0
    assert "gat_bwd" not in ma["graph_launches"]
    assert np.array_equal(sa, sb) and np.array_equal(la, lb) and np.array_equal(pa, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev", [4, 2])
@pytest.mark.parametrize("f,dtype", [(64, torch.bfloat16), (168, torch.bfloat16),
                                     (64, torch.float32)])
def test_rectangular_kernel_matches_plain_and_whole(cuda, n_dev, f, dtype):
    """The GSPMD row sharding's launch: every rank's slice of destination
    chunks (forward and transpose tables), reading every row, against its
    plain version and bit for bit against the whole graph's launch."""
    from elliptic_gnn_tpu_torch.kernels.bsda_spmm_cuda import bsda_dense_cuda
    from elliptic_gnn_tpu_torch.parallel.gspmd_step import bsda_row_slice

    _, g = _graph()
    g = bsda.pad_bsda_chunks(g, n_dev)
    n_rows = g.num_chunks * g.chunk
    n_loc = n_rows // n_dev
    x = _randn((n_rows, f), 4, cuda, dtype)
    tol = F32 if dtype == torch.float32 else BF16
    for table in (g, g.transpose):
        whole = bsda_dense_cuda(table.to(cuda), x)
        for d in range(n_dev):
            view = bsda_row_slice(table, n_dev, d).to(cuda)
            got = bsda_dense_cuda(view, x, n_loc)
            assert got.shape == (n_loc, f) and got.dtype == dtype
            assert torch.equal(got, whole[d * n_loc: (d + 1) * n_loc])
            want = bsda.bsda_dense_plain(view, x, n_loc)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(), **tol)


def _band_gat_graph(n=2900, seed=5, n_band=600):
    """tests/torch_port_ranks.py::band_graph's 'gat' tables (depth 3, with
    the transpose): a symmetrized, BFS-renumbered synthetic graph plus
    random edges both ways between nodes at most 250 rows apart."""
    data = symmetrize_edges(synthetic.generate(num_nodes=n, num_timesteps=10, seed=seed))
    data = data.renumber(bsda.bfs_order(data.edge_index, n, data.timestep))
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, n_band)
    dst = np.clip(src + rng.integers(-250, 250, n_band), 0, n - 1)
    ei = np.concatenate([data.edge_index, np.stack([src, dst]),
                         np.stack([dst, src])], axis=1).astype(np.int64)
    return bsda.build_bsda_for_kind(ei, n, "gat", depth=3)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev", [4, 2])
@pytest.mark.parametrize("h,ch", [(4, 8), (1, 2)])
def test_rectangular_gat_kernels_match_plain_and_whole(cuda, n_dev, h, ch):
    """GAT on a mesh: the rectangular launches of the four GAT kernels of
    every GSPMD rank (its destination chunks over every payload row; the
    source sweep on its transpose slice over every G2 row) and of every
    halo shard (its table over its halo-extended rows; the source sweep on
    the block transpose over the ext grid, G2 at its ext offset), on the
    band graph of the multi-rank tests (tests/torch_port_ranks.py; a
    spill, a halo of two chunks):
    each against its plain version, and the ranks' forward rows, G2,
    d a_dst and source-sweep rows bit for bit against the whole graph's
    launch."""
    from elliptic_gnn_tpu_torch.parallel import gspmd_step
    from elliptic_gnn_tpu_torch.parallel import shardmap_step as sm

    g = bsda.pad_bsda_chunks(_band_gat_graph(), n_dev)
    n_rows = g.num_chunks * g.chunk
    n_loc, hc = n_rows // n_dev, h * ch
    width = gat_cuda.payload_width(h, ch)
    pay, gbar = _randn((n_rows, width), 5, cuda), _randn((n_rows, width), 6, cuda)
    gc = g.to(cuda)
    out = gat_cuda.gat_fwd_cuda(gc, pay, h, ch, 0.2, True)
    ct_d, g2 = gat_cuda.gat_bwd_dst_cuda(gc, gbar, pay, out, h, ch, 0.2, True)
    src = gat_cuda.gat_bwd_src_cuda(gc.transpose, pay, g2, h, ch, 0.2)
    sg = sm.partition_bsda(g, n_dev, use_kernel=True)
    for d in range(n_dev):
        own = slice(d * n_loc, (d + 1) * n_loc)
        rs = gspmd_step.row_sharded_bsda(g, n_dev, d).to(cuda)
        shard = sm.shard_slice(sg, d).to(cuda)
        halo, rows_ext = shard.halo_chunks * 128, shard.b_ext_pad * 128
        idx = (torch.arange(-halo, n_loc + halo, device=cuda) + d * n_loc) % n_rows
        ext = torch.cat([pay[idx], pay.new_zeros((rows_ext - idx.numel(), width))])
        g2_ext = torch.nn.functional.pad(g2[own], (0, 0, halo, rows_ext - halo - n_loc))
        for fwd_g, src_g, p, g2_src, row0, t_row0, whole in (
                (rs.fwd, rs.bwd, pay, g2, d * n_loc, d * n_loc, True),
                (sm._gat_view(shard), sm._transpose_view(shard), ext, g2_ext, halo, 0, False)):
            got = gat_cuda.gat_fwd_cuda(fwd_g, p, h, ch, 0.2, True, dst_row0=row0)
            ct1 = gat_cuda.gat_bwd_cuda(fwd_g, gbar[own], p, got, h, ch, 0.2, True, row0)
            dst_ct, dst_g2 = gat_cuda.gat_bwd_dst_cuda(fwd_g, gbar[own], p, got, h, ch, 0.2,
                                                       True, None, row0)
            src_ct = gat_cuda.gat_bwd_src_cuda(src_g, p, g2_src, h, ch, 0.2, None, t_row0)
            torch.cuda.synchronize()
            want = gat_cuda.gat_fwd_plain(fwd_g, p, h, ch, 0.2, True, row0)
            for a, b in zip(_gauge_free(got, h, ch, True), _gauge_free(want, h, ch, True)):
                np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **GAT_FWD)
            np.testing.assert_allclose(
                ct1.cpu().numpy(), gat_cuda.gat_bwd_plain(fwd_g, gbar[own], p, got, h, ch, 0.2,
                                                          True, row0).cpu().numpy(), **GAT_BWD)
            want_d, want_g2 = gat_cuda.gat_bwd_dst_fused_plain(fwd_g, gbar[own], p, got, h, ch,
                                                               0.2, True, row0)
            np.testing.assert_allclose(dst_ct.cpu().numpy(), want_d.cpu().numpy(), **GAT_BWD)
            np.testing.assert_allclose(dst_g2.cpu().numpy(), want_g2.cpu().numpy(), **GAT_BWD)
            np.testing.assert_allclose(
                src_ct.cpu().numpy(), gat_cuda.gat_bwd_src_plain(
                    src_g, p, g2_src, h, ch, 0.2, t_row0).cpu().numpy(), **GAT_BWD)
            if whole:
                assert torch.equal(got, out[own]) and torch.equal(dst_g2, g2[own])
                assert torch.equal(dst_ct[own, hc + h:], ct_d[own, hc + h:])
                assert torch.equal(src_ct[own, : hc + h], src[own, : hc + h])


@pytest.mark.cuda
@pytest.mark.parametrize("two_sweep", [False, True])
@pytest.mark.parametrize("agg", ["shard_map", "bsda"])
def test_gat_mesh_world_of_one_matches_single_device(cuda, tmp_path, kloop_graph,
                                                     monkeypatch, agg, two_sweep):
    """GAT at mesh_devices 1 as one NCCL rank (train_rank) on the halo path
    (shard_map) and the GSPMD row sharding (bsda): the K loop captures the
    packed route (on the GSPMD path its all-gathers too) and matches the
    single-device run, dropout 0, per-epoch loss and val PR-AUC within
    1e-4; the captured epoch launches the GAT kernels (the two sweeps with
    the two-sweep backward, else the one-sweep kernel)."""
    from elliptic_gnn_tpu_torch.train import train_gnn

    if two_sweep:
        monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0")
    m1, loss1, pr1, _ = _kloop_run(tmp_path, kloop_graph, "gat", 4, "one", dropout=0.0)
    monkeypatch.setattr(train_gnn, "main",
                        lambda cfg, init_params=None: train_gnn.train_rank(cfg, init_params))
    mg, lossg, prg, _ = _kloop_run(tmp_path, kloop_graph, "gat", 4, f"mesh_{agg}",
                                   aggregation=agg, dropout=0.0)
    assert mg["mesh_devices"] == 1 and mg["epochs_run"] == m1["epochs_run"]
    np.testing.assert_allclose(lossg, loss1, rtol=0, atol=1e-4)
    np.testing.assert_allclose(prg, pr1, rtol=0, atol=1e-4)
    kernels = ("gat_fwd_gated", "gat_fwd") + (
        ("gat_bwd_dst", "gat_bwd_src") if two_sweep else ("gat_bwd",))
    assert all(mg["graph_launches"].get(k, 0) > 0 for k in kernels), mg["graph_launches"]


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["bsda", "ell"])
def test_gspmd_world_of_one_matches_single_device(cuda, tmp_path, kloop_graph, agg):
    """The GSPMD row sharding as one NCCL rank (train_rank; the K loop
    captures its all-gathers) against the single-device run, dropout 0:
    per-epoch loss and val PR-AUC within 1e-4; the BSDA run launches the
    kernel in its captured epoch, the ELL run none."""
    from elliptic_gnn_tpu_torch.train import train_gnn

    m1, loss1, pr1, _ = _kloop_run(tmp_path, kloop_graph, "sage_resbn", 4, f"one_{agg}",
                                   aggregation=agg, dropout=0.0)
    real_main = train_gnn.main
    try:
        train_gnn.main = lambda cfg, init_params=None: train_gnn.train_rank(cfg, init_params)
        mg, lossg, prg, _ = _kloop_run(tmp_path, kloop_graph, "sage_resbn", 4,
                                       f"gspmd_{agg}", aggregation=agg, dropout=0.0)
    finally:
        train_gnn.main = real_main
    assert mg["mesh_devices"] == 1 and mg["epochs_run"] == m1["epochs_run"]
    np.testing.assert_allclose(lossg, loss1, rtol=0, atol=1e-4)
    np.testing.assert_allclose(prg, pr1, rtol=0, atol=1e-4)
    launched = sum(mg["graph_launches"].get(k, 0) for k in ("ring", "banded"))
    assert (launched > 0) == (agg == "bsda"), mg["graph_launches"]


@pytest.mark.cuda
def test_k_loop_failed_capture_raises(cuda, tmp_path, kloop_graph, monkeypatch):
    """An epoch that syncs with the host cannot be captured: the K loop
    raises and never slides back to the serial loop. (Last in the file: the
    failed capture is left behind in the process.)"""
    from elliptic_gnn_tpu_torch.train import train_gnn
    from elliptic_gnn_tpu_torch.utils import metrics

    real = metrics.pr_auc_illicit_device

    def host_synced(y, s):
        out = real(y, s)
        out.item()  # a host read: forbidden while a stream is captured
        return out

    monkeypatch.setattr(metrics, "pr_auc_illicit_device", host_synced)
    serial = []
    monkeypatch.setattr(train_gnn, "_serial_loop",
                        lambda *a, **k: serial.append(1) or pytest.fail("serial loop ran"))
    with pytest.raises(RuntimeError, match="capturing the training epoch as a CUDA graph"):
        _kloop_run(tmp_path, kloop_graph, "sage_resbn", 4, "capture_fails")
    assert not serial
