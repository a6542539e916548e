"""CUDA BSDA SpMM: binding and autograd wrapper for csrc/bsda_spmm.cu.

Port of elliptic_gnn_tpu/kernels/pallas_bsda.py. The kernel computes the
dense part of the aggregation on the GPU; the residual spill runs after it
in plain PyTorch (one index-add), and gradients run the same kernel on the
transpose tables (kernels/bsda.py::spmm_with).

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface under <repo>/build/torch_ext at first use, and loaded
with ctypes (kernels/cuda_build.py). There is no fallback: a missing
compiler, a failed build, a CPU tensor or a failed launch raises.

`launches` counts kernel launches per TPU variant the launch stands for
(see _variant), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .bsda import BsdaGraph, spmm_with

# the TPU kernel's dispatch (pallas_bsda.py:390-400): one 128-lane feature
# tile on a graph of more than RING G-blocks runs _ring_call, else
# _banded_call; the count is kept per variant for the kernel table
_FEAT_TILE, _GROUP, _RING = 128, 8, 4

launches = {"ring": 0, "banded": 0}
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("bsda_spmm")
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.bsda_spmm_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.bsda_spmm_launch.restype = ctypes.c_int
        lib.bsda_spmm_error_string.argtypes = [ctypes.c_int]
        lib.bsda_spmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _variant(g: BsdaGraph, f: int) -> str:
    nb = -(-g.num_chunks // max(_GROUP, int(g.max_chunk_dist)))
    ft_padded = -(-f // _FEAT_TILE) * _FEAT_TILE
    return "ring" if ft_padded == _FEAT_TILE and nb > _RING else "banded"


def kernel_table(g: BsdaGraph):
    """(A bytes, planes, pack) as the kernel reads them: the bit-packed
    planes when present, else the int8 multiplicity table (pack 1)."""
    if g.a_packed is not None and g.a_pack > 1:
        return g.a_packed, g.a_packed.shape[1], g.a_pack
    if g.a.dtype not in (torch.int8, torch.uint8):
        raise ValueError(
            f"the CUDA kernels take integer multiplicity tables "
            f"(a_dtype int8), not {g.a.dtype}")
    return g.a, g.depth, 1


def bsda_dense_cuda(g: BsdaGraph, xc: torch.Tensor) -> torch.Tensor:
    """Dense part of the BSDA SpMM on the GPU: [n0, F] in xc's dtype.
    Same function as kernels/bsda.py::bsda_dense_plain."""
    if not xc.is_cuda:
        raise ValueError("bsda_dense_cuda takes CUDA tensors; the plain "
                         "version is kernels/bsda.py::bsda_dense_plain")
    if xc.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, not {xc.dtype}")
    if xc.dim() != 2:
        raise ValueError(f"x must be [N, F], got {tuple(xc.shape)}")
    if g.chunk != 128:
        raise ValueError(f"the kernel is built for 128-row chunks, not {g.chunk}")
    a, planes, pack = kernel_table(g)
    n0, f = xc.shape
    if n0 > g.num_chunks * g.chunk:
        raise ValueError(f"x has {n0} rows; the tables hold {g.num_chunks * g.chunk}")
    tensors = [a, g.src_chunk] + [s for s in (g.dst_scale, g.src_scale)
                                  if s is not None]
    for t in tensors:
        if t.device != xc.device:
            raise ValueError(f"BSDA tables on {t.device}, x on {xc.device}")
        if not t.is_contiguous():
            raise ValueError("BSDA tables must be contiguous")
    if tuple(a.shape) != (g.num_chunks, planes, 128, 128) or a.data_ptr() % 16:
        raise ValueError(f"A table of shape {tuple(a.shape)} is not the "
                         f"16-byte-aligned [B, planes, 128, 128] the kernel reads")
    if g.src_chunk.dtype != torch.int32:
        raise ValueError(f"src_chunk must be int32, not {g.src_chunk.dtype}")
    xc = xc.contiguous()
    out = torch.empty_like(xc)
    if n0 == 0 or f == 0:
        return out
    lib = _load()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        rc = lib.bsda_spmm_launch(
            ptr(a), ptr(g.src_chunk), ptr(xc), ptr(g.dst_scale),
            ptr(g.src_scale), ptr(out), g.num_chunks, g.depth, planes, pack,
            n0, f, 0 if xc.dtype == torch.float32 else 1, stream)
    if rc != 0:
        raise RuntimeError(
            f"bsda_spmm launch failed: {lib.bsda_spmm_error_string(rc).decode()}")
    launches[_variant(g, f)] += 1
    return out


def bsda_spmm_cuda(g: BsdaGraph, x: torch.Tensor,
                   compute_dtype=None) -> torch.Tensor:
    """out = A_w @ x on the GPU through the kernel, in x's dtype; the
    gradient runs the kernel on g.transpose."""
    if g.transpose is None and x.requires_grad and torch.is_grad_enabled():
        raise ValueError("gradients through the CUDA BSDA kernel need the "
                         "transpose tables (build with transpose=True)")
    return spmm_with(g, x, bsda_dense_cuda, compute_dtype)
