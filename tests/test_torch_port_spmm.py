"""Port parity: the plain PyTorch BSDA SpMM (forward and autograd backward
through the transpose tables) against the JAX package's Pallas kernel
(interpret mode off-TPU, as tests/test_pallas_bsda.py runs it) and its XLA
bsda_spmm, on the same tables and inputs. The CUDA kernel is held against
the plain version in tests/test_torch_port_cuda.py.

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
