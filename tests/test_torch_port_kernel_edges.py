"""Port parity at the ragged edges of the CUDA kernels built on the edge
list (csrc/bsda_edges.cuh): the plain versions they are held against on
the card (bsda_dense_plain, gat_fwd_plain, gat_bwd_plain and the two
sweeps' gat_bwd_dst_plain + gat_bwd_src_plain) against the JAX package's
Pallas kernels (interpret mode off-TPU, as tests/test_torch_port_spmm.py
and test_torch_port_gat.py run them), on graphs that strain the per-chunk
edge handling: a hub chunk that holds thousands of dense edges, a row with
hundreds of sources, a chunk with no edge at all, a node count that is no
multiple of 128, narrow and odd feature widths, and (for the backward) an
out-hub: a source with hundreds of destinations and a source chunk with
thousands of out-edges, which the source sweep walks as one row and as
several edge lists. Inputs come from a numpy seed. The kernels themselves
run these graphs in tests/test_torch_port_cuda.py.

Tolerances: SpMM f32 rtol 1e-5, atol 1e-5 (f32 sums in another order);
bf16 rtol 1/64, atol 1e-3 (one bf16 rounding of a result of order 1, sums
in another order). GAT on the gauge-free acc / s and m + log s only, rtol
1e-4, atol 1e-5 (the TPU kernels shift by an upper bound, the port by the
exact row max; a hub row sums hundreds of terms). GAT backward on the grad
payload G2 (the shift m given, so no gauge differs) rtol 1e-5, atol 1e-5:
the same f32 sums in another order, with a rank-1 separable exponent in
the TPU kernels (tests/test_torch_port_gat_bwd2.py's tolerance)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.kernels import pallas_gat, pallas_gat_bwd
from elliptic_gnn_tpu.kernels.pallas_bsda import pallas_bsda_spmm
from elliptic_gnn_tpu_torch.graph.synthetic import hub_edges
from elliptic_gnn_tpu_torch.kernels import bsda as port_bsda
from elliptic_gnn_tpu_torch.kernels import gat_cuda

from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1 / 64, atol=1e-3)
GAT = dict(rtol=1e-4, atol=1e-5)
SWEEP = dict(rtol=1e-5, atol=1e-5)
SLOPE = 0.2
N_SPMM = 700            # 6 chunks, the last one ragged
N_GAT = 128 * 40 - 50   # enough chunks for the TPU kernel's ring, ragged


def _hub_tables(n, kind, depth):
    ei = hub_edges(n, seed=11)
    gj = jax_bsda.build_bsda_for_kind(ei, n, kind, depth=depth, a_dtype="int8")
    gp = port_bsda.build_bsda_for_kind(ei, n, kind, depth=depth, a_dtype="int8")
    per_chunk = (gp.a != 0).sum(dim=(1, 2, 3))
    assert int(per_chunk[1]) > 2048          # more than one edge list
    assert int((gp.a[1, :, 5] != 0).sum()) > 256  # a row over several batches
    return gj, gp, per_chunk


@pytest.mark.parametrize("kind,f,amp", [
    ("sage", 1, False), ("sage", 2, False), ("sage", 3, False), ("sage", 63, False),
    ("sage", 65, False), ("sage", 2, True), ("sage", 63, True), ("gcn", 3, False),
    ("gcn", 65, True), ("gcn", 2, True)])
def test_dense_plain_matches_pallas_on_hub_graph(kind, f, amp):
    """bsda_dense_plain (with the spill, if any) against pallas_bsda_spmm on
    the hub graph: forward tables and, through the gradient, the transpose
    tables' plain version too."""
    gj, gp, per_chunk = _hub_tables(N_SPMM, kind, 3)
    if kind == "sage":
        assert int(per_chunk[3]) == 0        # the chunk without edges
    gj = dataclasses.replace(gj, use_pallas_kernel=True)
    x = np.random.default_rng(f).standard_normal((N_SPMM, f)).astype(np.float32)
    xt = torch.from_numpy(x)
    if amp:
        xt = xt.to(torch.bfloat16)
    got = port_bsda.bsda_forward(gp, xt, port_bsda.bsda_dense_plain).float().numpy()
    got_t = port_bsda.bsda_forward(
        gp.transpose, xt, port_bsda.bsda_dense_plain).float().numpy()
    cdt = jnp.bfloat16 if amp else None
    want = np.asarray(pallas_bsda_spmm(gj, jnp.asarray(x), compute_dtype=cdt))
    want_t = np.asarray(pallas_bsda_spmm(
        dataclasses.replace(gj.transpose, use_pallas_kernel=True), jnp.asarray(x),
        compute_dtype=cdt))
    tol = BF16 if amp else F32
    assert got.shape == (N_SPMM, f)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got_t, want_t, **tol)
    if kind == "sage":
        np.testing.assert_array_equal(got[3 * 128: 4 * 128], 0.0)


def _gauge_free(out, h, ch, normalized):
    hc = h * ch
    acc = out[:, :hc].reshape(-1, h, ch)
    m, s = out[:, hc: hc + h], out[:, hc + h: hc + 2 * h]
    val = acc if normalized else acc / np.maximum(s, 1e-16)[..., None]
    return val, m + np.log(np.maximum(s, 1e-30))


@pytest.fixture(scope="module")
def gat_tables():
    gj, gp, _ = _hub_tables(N_GAT, "gat", 4)
    assert pallas_gat.flash_eligible(gj, 4, 8)
    return gj, gp


@pytest.mark.parametrize("h,ch", [(1, 1), (1, 2), (4, 8), (3, 5)])
@pytest.mark.parametrize("normalize", [False, True])
def test_gat_fwd_plain_matches_flash_kernel_on_hub_graph(gat_tables, h, ch, normalize):
    """gat_fwd_plain against flash_gat_payload in interpret mode on the hub
    graph (gated for h >= 2, all slots for h = 1)."""
    gj, gp = gat_tables
    n_pad = gp.num_chunks * gp.chunk
    w = gat_cuda.payload_width(h, ch)
    pay = (0.5 * np.random.default_rng(h * 100 + ch).standard_normal(
        (n_pad, w))).astype(np.float32)
    lanes = np.zeros((n_pad, pallas_gat.pack_width(h, ch)), np.float32)
    lanes[:, :w] = pay
    want = pallas_gat.flash_gat_payload(gj, jnp.asarray(lanes), h, ch, SLOPE,
                                        normalize=normalize)
    assert want is not None
    got = gat_cuda.gat_fwd_plain(gp, torch.from_numpy(pay), h, ch, SLOPE, normalize)
    assert got.shape == pay.shape and bool(torch.isfinite(got).all())
    for a, b, name in zip(_gauge_free(got.numpy(), h, ch, normalize),
                          _gauge_free(np.asarray(want)[:, :w], h, ch, normalize),
                          ("acc/s", "m+log s")):
        np.testing.assert_allclose(a[:N_GAT], b[:N_GAT], err_msg=name, **GAT)
    # padding rows hold no edge: s = 0, acc = 0, m = -1e30
    hc = h * ch
    np.testing.assert_array_equal(got.numpy()[N_GAT:, :hc], 0.0)
    np.testing.assert_array_equal(got.numpy()[N_GAT:, hc: hc + h], np.float32(-1e30))


@pytest.fixture(scope="module")
def out_hub_tables():
    """GAT tables of hub_edges with the out-hub, and their transpose: the
    transpose's chunk 1 holds more edges than one edge list (kMinListCap,
    2048), its row 9 (the out-hub source) hundreds."""
    ei = hub_edges(N_GAT, seed=11, out_hub=True)
    gj = jax_bsda.build_bsda_for_kind(ei, N_GAT, "gat", depth=4, transpose=True)
    gp = port_bsda.build_bsda_for_kind(ei, N_GAT, "gat", depth=4, transpose=True)
    t = gp.transpose
    assert int((t.a[1] != 0).sum()) > 2048
    assert int((t.a[1, :, 9] != 0).sum()) > 256
    return gj, gp


def _payload_and_g2(n, h, ch, seed):
    """Numpy payload [n, h*ch + 2h] and grad payload G2 [n, h*ch + 3h] in
    the raw gauge; the m columns hold a constant above every lrelu(t), so
    that the exponent stays negative as after a real forward."""
    rng = np.random.default_rng(seed)
    hc = h * ch
    pay = (0.3 * rng.standard_normal((n, hc + 2 * h))).astype(np.float32)
    g2 = np.empty((n, hc + 3 * h), np.float32)
    g2[:, : hc + h] = 0.3 * rng.standard_normal((n, hc + h))
    g2[:, hc + h: hc + 2 * h] = pay[:, hc + h:]
    g2[:, hc + 2 * h:] = 2.5
    return pay, g2


@pytest.mark.parametrize("h,ch", [(4, 8), (1, 2), (3, 5)])
@pytest.mark.parametrize("sweeps", ["one", "two"])
def test_gat_bwd_plain_matches_pallas_on_out_hub_graph(out_hub_tables, monkeypatch,
                                                       h, ch, sweeps):
    """The backward's plain versions against flash_gat_backward in
    interpret mode on the out-hub graph: `one`, gat_bwd_plain (raw gauge:
    gbar = [A | - | S], m from out_k) against the one-sweep route
    (_sweep_fused_call); `two`, gat_bwd_dst_plain + gat_bwd_src_plain over
    the row-oriented transpose tables against the two-sweep route
    (_sweep_dst_call, _sweep_src_call)."""
    gj, gp = out_hub_tables
    n_pad = gp.num_chunks * gp.chunk
    hc = h * ch
    pay, g2 = _payload_and_g2(n_pad, h, ch, 31 + h)
    if sweeps == "one":
        monkeypatch.delenv("EGNN_GAT_ONE_SWEEP", raising=False)
    else:
        monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0")
    assert pallas_gat_bwd.one_sweep_eligible(gj, h, ch) == (sweeps == "one")
    lanes1 = np.zeros((n_pad, pallas_gat.pack_width(h, ch)), np.float32)
    lanes1[:, : pay.shape[1]] = pay
    lanes2 = np.zeros((n_pad, pallas_gat_bwd.g2_pack_width(h, ch)), np.float32)
    lanes2[:, : g2.shape[1]] = g2
    want = pallas_gat_bwd.flash_gat_backward(gj, jnp.asarray(lanes1), jnp.asarray(lanes2),
                                             h, ch, SLOPE)
    assert want is not None
    want = np.asarray(want)[:, : pay.shape[1]]
    pay_t, g2_t = torch.from_numpy(pay), torch.from_numpy(g2)
    if sweeps == "one":
        gbar = torch.zeros_like(pay_t)
        gbar[:, :hc], gbar[:, hc + h:] = g2_t[:, :hc], g2_t[:, hc: hc + h]
        out_k = torch.zeros_like(pay_t)
        out_k[:, hc: hc + h], out_k[:, hc + h:] = g2_t[:, hc + 2 * h:], 1.0
        got = gat_cuda.gat_bwd_plain(gp, gbar, pay_t, out_k, h, ch, SLOPE, False)
    else:
        d_src = gat_cuda.gat_bwd_src_plain(gp.transpose, pay_t, g2_t, h, ch, SLOPE)
        assert not d_src[:, hc + h:].any()
        got = gat_cuda.gat_bwd_dst_plain(gp, g2_t, pay_t, h, ch, SLOPE) + d_src
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, **SWEEP)
    # the out-hub source's d xp sums hundreds of edges
    assert np.abs(want[128 + 9, :hc]).max() > 0
