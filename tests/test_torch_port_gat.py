"""Port parity for the GAT functions: the torch package's plain
formulation, the plain versions of its two CUDA kernels, and the packed
pipeline, against the JAX package on the same tables and numpy-seeded
inputs. The JAX Pallas kernels run in interpret mode, as the JAX package's
own tests run them on the CPU; the JAX references without them compile
whole (tests/jax_reference.py). The CUDA kernels are held against the plain
versions in tests/test_torch_port_cuda.py.

The graph: n = 128 * 24 nodes so that the TPU kernels' flash_eligible
holds, 60 far edges so that a residual spill exists, duplicate edges for
multiplicities > 1.

Tolerances: bsda_gat_aggregate value and gradients rtol 1e-5 (atol 1e-6:
the same f32 formulation, sums in another order); the forward against the
flash kernel on the gauge-free acc / s and m + log s, rtol 1e-5, atol 1e-6
(m and s alone differ: the TPU kernels shift by an upper bound, the port
by the exact row max); the backward against flash_gat_backward3 rtol 5e-4,
atol 5e-5, and packed-pipeline parameter gradients the same (the JAX
package's own tolerance for these, tests/test_gat_bwd.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.kernels import bsda_gat as jax_bsda_gat
from elliptic_gnn_tpu.kernels import ell as jax_ell
from elliptic_gnn_tpu.kernels import packed_gat as jax_packed
from elliptic_gnn_tpu.kernels import pallas_gat, pallas_gat_bwd
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu_torch.kernels import bsda as port_bsda
from elliptic_gnn_tpu_torch.kernels import bsda_gat, ell, gat_bwd, gat_cuda, packed_gat
from elliptic_gnn_tpu_torch.models import build_model
from elliptic_gnn_tpu_torch.models.convert import params_from_jax
from tests.jax_reference import jit_as_eager
from tests.test_torch_port_tables import port_graph
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

N = 128 * 24
SLOPE = 0.2
VALUE = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=5e-4, atol=5e-5)
HEADS = [(4, 8), (1, 2), (2, 16)]


@pytest.fixture(scope="module")
def graphs():
    """(edge_index, JAX tables, port tables) at depth 3, no transpose."""
    rng = np.random.default_rng(7)
    ei, _ = port_graph(N, 8, 1.5, seed=7, n_far=60)
    ei = np.concatenate([ei, ei[:, rng.integers(0, ei.shape[1], 40)]], axis=1)
    gj = jax_bsda.build_bsda_for_kind(ei, N, "gat", depth=3, transpose=False)
    gp = port_bsda.build_bsda_for_kind(ei, N, "gat", depth=3, transpose=False)
    assert gp.residual is not None and int(gp.a.max()) > 1
    assert pallas_gat.flash_eligible(gj, 4, 8)
    return ei, gj, gp


def _payload(h, ch, seed):
    """Numpy payload [N, h*ch + 2h] (the port's width) and its 128-lane
    padded copy for the TPU kernels."""
    rng = np.random.default_rng(seed)
    w = gat_cuda.payload_width(h, ch)
    pay = (0.5 * rng.standard_normal((N, w))).astype(np.float32)
    return pay, _lanes(pay, h, ch)


def _lanes(a, h, ch):
    out = np.zeros((a.shape[0], pallas_gat.pack_width(h, ch)), np.float32)
    out[:, : a.shape[1]] = a
    return out


def _gauge_free(out, h, ch, normalized):
    """(acc / s, m + log s) of packed rows; rows with s = 0 give 0 and m."""
    hc = h * ch
    acc = out[:, :hc].reshape(-1, h, ch)
    m, s = out[:, hc: hc + h], out[:, hc + h: hc + 2 * h]
    val = acc if normalized else acc / np.maximum(s, 1e-16)[..., None]
    return val, m + np.log(np.maximum(s, 1e-30))


def test_ell_gat_aggregate_matches(graphs):
    from elliptic_gnn_tpu.graph.transform import add_self_loops

    ei = add_self_loops(graphs[0], N)
    gj = jax_ell.build_ell_graph(ei, N)
    gp = ell.build_ell_graph(ei, N)
    rng = np.random.default_rng(3)
    xp = rng.standard_normal((N, 4, 8)).astype(np.float32)
    a_s = rng.standard_normal((N, 4)).astype(np.float32)
    a_d = rng.standard_normal((N, 4)).astype(np.float32)
    want = jit_as_eager(lambda *t: jax_ell.ell_gat_aggregate(gj, *t, SLOPE))(
        jnp.asarray(xp), jnp.asarray(a_s), jnp.asarray(a_d))
    got = ell.ell_gat_aggregate(gp, torch.from_numpy(xp), torch.from_numpy(a_s),
                                torch.from_numpy(a_d), SLOPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE)


@pytest.mark.parametrize("h,ch", [(4, 8), (2, 16)])
def test_bsda_gat_aggregate_value_and_grads_match(graphs, h, ch):
    """(a) the plain formulation and autograd through it, against the JAX
    one and jax.grad; and the closed-form attend_bwd against autograd."""
    _, gj, gp = graphs
    rng = np.random.default_rng(5)
    xp = rng.standard_normal((N, h, ch)).astype(np.float32)
    a_s = rng.standard_normal((N, h)).astype(np.float32)
    a_d = rng.standard_normal((N, h)).astype(np.float32)
    wout = rng.standard_normal((N, h, ch)).astype(np.float32)

    def loss_j(xp, a_s, a_d):
        y = jax_bsda_gat.bsda_gat_aggregate(gj, xp, a_s, a_d, SLOPE)
        return jnp.sum(y * wout) + jnp.sum(jnp.sin(y) * 0.1), y

    vg = jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True)
    (_, y_j), g_j = jit_as_eager(vg)(jnp.asarray(xp), jnp.asarray(a_s), jnp.asarray(a_d))

    t = [torch.from_numpy(v).requires_grad_(True) for v in (xp, a_s, a_d)]
    y_p = bsda_gat.bsda_gat_aggregate(gp, *t, SLOPE)
    loss = (y_p * torch.from_numpy(wout)).sum() + (torch.sin(y_p) * 0.1).sum()
    gbar, = torch.autograd.grad(loss, y_p, retain_graph=True)
    loss.backward()
    np.testing.assert_allclose(y_p.detach().numpy(), np.asarray(y_j), **VALUE)
    for got, want, name in zip(t, g_j, ("dxp", "dasrc", "dadst")):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   err_msg=name, **VALUE)

    # closed form (dense blocks + spill) == autograd, on the padded arrays
    with torch.no_grad():
        pads = (bsda_gat.pad_to_chunks(gp, t[0]),
                bsda_gat.pad_to_chunks(gp, t[1], bsda_gat.NEG_INF),
                bsda_gat.pad_to_chunks(gp, t[2], bsda_gat.NEG_INF))
        y, m, s = bsda_gat.attend(gp, *pads, SLOPE)
        closed = gat_bwd.attend_bwd(gp, SLOPE, (*pads, m, s, y),
                                    bsda_gat.pad_to_chunks(gp, gbar))
    for got, want, name in zip(closed, t, ("dxp", "dasrc", "dadst")):
        np.testing.assert_allclose(got[:N].numpy(), want.grad.numpy(),
                                   err_msg=name, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("h,ch", HEADS)
@pytest.mark.parametrize("normalize", [False, True])
def test_plain_forward_matches_flash_kernel(graphs, h, ch, normalize):
    """(b) the forward kernel's plain version against flash_gat_payload in
    interpret mode: gated for h >= 2, unrolled for h = 1."""
    _, gj, gp = graphs
    pay, pay_lanes = _payload(h, ch, 11)
    want = pallas_gat.flash_gat_payload(gj, jnp.asarray(pay_lanes), h, ch, SLOPE,
                                        normalize=normalize)
    got = gat_cuda.gat_fwd(gp, torch.from_numpy(pay), h, ch, SLOPE, normalize)
    assert got.shape == pay.shape
    for a, b, name in zip(_gauge_free(got.numpy(), h, ch, normalize),
                          _gauge_free(np.asarray(want), h, ch, normalize),
                          ("acc/s", "m+log s")):
        np.testing.assert_allclose(a, b, err_msg=name, **VALUE)


def test_plain_forward_empty_rows_are_finite(graphs):
    """Rows with no dense edge: s = 0, acc = 0, m = -1e30 (not -inf)."""
    _, _, gp = graphs
    h, ch = 2, 3
    ei = np.zeros((2, 0), np.int64)
    g = port_bsda.build_bsda_for_kind(ei, 200, "gat", depth=2, transpose=False)
    pay = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (256, gat_cuda.payload_width(h, ch))).astype(np.float32))
    out = gat_cuda.gat_fwd(g, pay, h, ch, SLOPE, normalize=True).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[200:, : h * ch], 0.0)
    np.testing.assert_array_equal(out[200:, h * ch: h * ch + h], np.float32(-1e30))
    np.testing.assert_array_equal(out[200:, h * ch + h:], 0.0)
    # rows 0..199 hold only their self-loop: val = xp, s = 1
    np.testing.assert_allclose(out[:200, : h * ch], pay.numpy()[:200, : h * ch], **VALUE)
    np.testing.assert_allclose(out[:200, h * ch + h:], 1.0, **VALUE)


@pytest.mark.parametrize("h,ch", HEADS)
@pytest.mark.parametrize("normalized", [False, True])
def test_plain_backward_matches_fused_sweep(graphs, h, ch, normalized):
    """(c) the backward kernel's plain version against flash_gat_backward3
    in interpret mode, in the raw and the normalized gauge. Each side gets
    its own forward's output and the cotangent of a gauge-free loss in it:
    the cotangent of the payload then does not depend on the shift."""
    _, gj, gp = graphs
    pay, pay_lanes = _payload(h, ch, 13)
    hc = h * ch
    rng = np.random.default_rng(17)
    c = (0.5 * rng.standard_normal((N, h, ch))).astype(np.float32)
    d = (0.5 * rng.standard_normal((N, h))).astype(np.float32)
    junk = rng.standard_normal((N, h)).astype(np.float32)

    def cotangent(out):
        """Cotangent of the gauge-free L = sum(c * acc / s) + sum(d * log s)
        in the columns of `out`; the m columns hold junk (never read)."""
        s = np.maximum(out[:, hc + h: hc + 2 * h], 1e-16)
        gb = np.zeros_like(pay)
        gb[:, hc: hc + h] = junk
        if normalized:
            gb[:, :hc] = c.reshape(-1, hc)
            gb[:, hc + h:] = d / s
        else:
            acc = out[:, :hc].reshape(-1, h, ch)
            gb[:, :hc] = (c / s[..., None]).reshape(-1, hc)
            gb[:, hc + h:] = d / s - (c * acc).sum(-1) / (s * s)
        return gb

    out_p = gat_cuda.gat_fwd(gp, torch.from_numpy(pay), h, ch, SLOPE, normalized)
    got = gat_cuda.gat_bwd(gp, torch.from_numpy(cotangent(out_p.numpy())),
                           torch.from_numpy(pay), out_p, h, ch, SLOPE, normalized)
    out_j = pallas_gat.flash_gat_payload(gj, jnp.asarray(pay_lanes), h, ch, SLOPE,
                                         normalize=normalized)
    want = pallas_gat_bwd.flash_gat_backward3(
        gj, jnp.asarray(pay_lanes),
        jnp.asarray(_lanes(cotangent(np.asarray(out_j)[:, : pay.shape[1]]), h, ch)),
        out_j, h, ch, SLOPE, normalized=normalized)
    assert want is not None
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, : pay.shape[1]], **BWD)


GAT_CFG = {"hidden_dim": 32, "layers": 2, "heads": 4, "dropout": 0.0}
F_IN = 24


@pytest.fixture(scope="module")
def jax_gat():
    """The JAX GAT model of GAT_CFG, its init (seed 1) and the inputs x, y:
    built once for the tests of the packed pipeline."""
    mj = jax_build_model("gat", F_IN, GAT_CFG)
    params, state = mj.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    y = rng.integers(0, 2, N).astype(np.int64)
    return mj, params, state, x, y


def _gat_setup(graphs, jax_gat):
    """(gj, gp, mj, params, state, mp, x, y): a fresh port model holding the
    JAX model's parameters."""
    _, gj, gp = graphs
    mj, params, state, x, y = jax_gat
    mp = build_model("gat", F_IN, GAT_CFG)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    params_from_jax(to_np(params), to_np(state), mp)
    return gj, gp, mj, params, state, mp, x, y


def _layer_params(mp):
    return [dict(w=l.w, a_src=l.a_src, a_dst=l.a_dst, b=l.b) for l in mp.layers]


def test_packed_forward_matches(graphs, jax_gat):
    """(d) packed_gat_forward (the CUDA eval path, here through the plain
    versions) against the JAX packed forward and the JAX per-layer model."""
    gj, gp, mj, params, state, mp, x, _ = _gat_setup(graphs, jax_gat)
    want = jit_as_eager(lambda p: jax_packed.packed_gat_forward(p, jnp.asarray(x), gj))(
        params["layers"])
    assert want is not None
    ref = jit_as_eager(lambda p: mj.apply(p, state, jnp.asarray(x), gj, training=False)[0])(
        params)
    got = packed_gat.packed_gat_forward(_layer_params(mp), torch.from_numpy(x), gp)
    assert got.shape == (N, 2) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    # the port's per-layer model (the CPU path) agrees too
    mp.eval()
    with torch.no_grad():
        per_layer = mp(torch.from_numpy(x), gp)
    np.testing.assert_allclose(per_layer.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def jax_loss_grads(graphs, jax_gat):
    """The loss and jax.grad through the JAX per-layer model: the reference
    of both paths of test_train_forward_grads_match, computed once."""
    _, gj, _ = graphs
    mj, params, state, x, y = jax_gat

    def loss_j(p):
        logits, _ = mj.apply(p, state, jnp.asarray(x), gj, training=True,
                             rng=jax.random.key(0))
        logp = jax.nn.log_softmax(logits, axis=1)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1).mean()

    return jit_as_eager(jax.value_and_grad(loss_j))(params)


@pytest.mark.parametrize("path", ["packed", "per_layer"])
def test_train_forward_grads_match(graphs, jax_gat, jax_loss_grads, path):
    """(d) loss and parameter gradients: packed_gat_train_forward (attend
    as an autograd.Function over the plain backward) and the per-layer
    autograd path, against jax.grad through the JAX per-layer model."""
    gj, gp, mj, params, state, mp, x, y = _gat_setup(graphs, jax_gat)
    l_j, g_j = jax_loss_grads
    mp.train()
    if path == "packed":
        logits = packed_gat.packed_gat_train_forward(
            _layer_params(mp), torch.from_numpy(x), gp)
    else:
        logits = mp(torch.from_numpy(x), gp)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-5)
    for layer, gl in zip(mp.layers, g_j["layers"]):
        for name in ("w", "a_src", "a_dst", "b"):
            np.testing.assert_allclose(getattr(layer, name).grad.numpy(),
                                       np.asarray(gl[name]), err_msg=name, **BWD)
