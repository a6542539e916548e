"""Port parity at the ragged edges of the two redesigned CUDA kernels: the
plain versions they are held against on the card (bsda_dense_plain,
gat_fwd_plain) against the JAX package's Pallas kernels (interpret mode
off-TPU, as tests/test_torch_port_spmm.py and test_torch_port_gat.py run
them), on graphs that strain the per-chunk edge handling: a hub chunk that
holds thousands of dense edges, a row with hundreds of sources, a chunk
with no edge at all, a node count that is no multiple of 128, narrow and
odd feature widths. Inputs come from a numpy seed. The kernels themselves
run these graphs in tests/test_torch_port_cuda.py.

Tolerances: SpMM f32 rtol 1e-5, atol 1e-5 (f32 sums in another order);
bf16 rtol 1/64, atol 1e-3 (one bf16 rounding of a result of order 1, sums
in another order). GAT on the gauge-free acc / s and m + log s only, rtol
1e-4, atol 1e-5 (the TPU kernels shift by an upper bound, the port by the
exact row max; a hub row sums hundreds of terms)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.kernels import pallas_gat
from elliptic_gnn_tpu.kernels.pallas_bsda import pallas_bsda_spmm
from elliptic_gnn_tpu_torch.graph.synthetic import hub_edges
from elliptic_gnn_tpu_torch.kernels import bsda as port_bsda
from elliptic_gnn_tpu_torch.kernels import gat_cuda

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1 / 64, atol=1e-3)
GAT = dict(rtol=1e-4, atol=1e-5)
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
