"""The port's CUDA BSDA kernel against its plain PyTorch version, on the
card. Every test here needs an NVIDIA GPU and skips without one; this file
imports nothing of JAX so that it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: f32 rtol 1e-5, atol 1e-5 (the same f32 products summed in
another order); bf16 results rtol 1/64, atol 1e-3 (two bf16 ulps: the f32
sums may round to neighbouring bf16 values); full SpMM and model outputs
under amp rtol 2e-2, atol 2e-2.
"""
import dataclasses

import numpy as np
import pytest
import torch

from elliptic_gnn_tpu_torch.graph import synthetic
from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges
from elliptic_gnn_tpu_torch.kernels import bsda
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
