"""CUDA ELL SpMM: binding and autograd wrapper for csrc/ell_spmm.cu.

    out = ell_spmm_cuda(g, x)    # [num_nodes, F] f32

the aggregation of an EllGraph that carries its flat tables
(kernels/ell.py::with_flat_tables), out[d] = row_scale[d] * sum_e w_e *
x[src_e], in one launch over every row (zero-degree rows written as
zeros). The gradient is the same kernel on the transpose tables (g.flat_t),
applied to the cotangent where x needs one: no atomics and no zero fill,
two runs give the same bits.

It replaces no Pallas kernel: the JAX package ran ELL as plain gathers
(kernels/ell.py::ell_weighted_sum, the plain version that CPU tensors take
and the kernel is held against). The source is compiled with nvcc for
sm_90a at first use (kernels/cuda_build.py) and loaded with ctypes. There
is no fallback: a CPU tensor, a missing compiler, a failed build or
launch, or an input the kernel does not take raises. Operands: f32, x
contiguous with the tables' n_src rows.

`launches` counts launches, the transpose's included.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .ell import LONG_DEGREE, EllGraph, EllTables

launches = {"ell_spmm": 0}
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        # a SAGE-ResBN step needs the epilogue too, whose binding asks for
        # bsda_spmm with it: one parallel nvcc batch
        lib = ctypes.CDLL(cuda_build.build(
            ("ell_spmm", "bsda_spmm", "resbn_epilogue"))["ell_spmm"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ell_spmm_launch.argtypes = [p] * 5 + [i, i, p, p, i, i, p]
        lib.ell_spmm_launch.restype = i
        lib.ell_spmm_error_string.argtypes = [i]
        lib.ell_spmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ell_spmm_launch(t: EllTables, x: torch.Tensor) -> torch.Tensor:
    """One launch: [t.n_rows, F] f32 from x [t.n_src, F] f32 on the GPU.
    Same function as ell_weighted_sum on the encoding the tables came from."""
    if not x.is_cuda:
        raise ValueError("ell_spmm_launch takes CUDA tensors; the plain version "
                         "is kernels/ell.py::ell_weighted_sum")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, not {x.dtype}")
    if x.dim() != 2 or x.shape[0] != t.n_src:
        raise ValueError(f"x must be [{t.n_src}, F], got {tuple(x.shape)}")
    want = ((t.row_ptr, torch.int32), (t.col, torch.int32), (t.weight, torch.float32),
            (t.scale, torch.float32), (t.long_rows, torch.int32))
    for ten, dtype in want:
        if ten is None:
            continue
        if ten.device != x.device:
            raise ValueError(f"ELL tables on {ten.device}, x on {x.device}")
        if ten.dtype != dtype or ten.dim() != 1 or not ten.is_contiguous():
            raise ValueError(f"ELL table of {ten.dtype} {tuple(ten.shape)}: the kernel "
                             f"reads contiguous 1-D {dtype}")
    n_rows, f = t.n_rows, int(x.shape[1])
    if t.col.shape != t.weight.shape or (t.scale is not None and t.scale.shape[0] != n_rows):
        raise ValueError("ELL tables of inconsistent sizes")
    if max(n_rows, f) >= 1 << 31:
        raise ValueError(f"[{n_rows}, {f}]: the kernel counts rows and columns in 32 bits")
    out = x.new_empty((n_rows, f))
    if n_rows == 0 or f == 0:
        return out
    x = x.contiguous()
    lib = _load()

    def ptr(ten):
        return None if ten is None else ten.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ell_spmm_launch(ptr(t.row_ptr), ptr(t.col), ptr(t.weight), ptr(t.scale),
                                 ptr(t.long_rows), int(t.long_rows.shape[0]), LONG_DEGREE,
                                 ptr(x), ptr(out), n_rows, f, stream)
    if rc != 0:
        raise RuntimeError(
            f"ell_spmm launch failed: {lib.ell_spmm_error_string(rc).decode()}")
    launches["ell_spmm"] += 1
    return out


class _EllSpmm(torch.autograd.Function):
    """d(A @ x)/dx applied to ct is A^T @ ct: the kernel on the transpose
    (applied only where x takes a gradient)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return ell_spmm_launch(fwd, x)

    @staticmethod
    def backward(ctx, ct):
        return ell_spmm_launch(ctx.bwd, ct.contiguous()), None, None


def ell_spmm_cuda(g: EllGraph, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x through the kernel on g.flat; the gradient through the
    kernel on g.flat_t, which it needs where x takes one."""
    if x.requires_grad and torch.is_grad_enabled():
        if g.flat_t is None:
            raise ValueError("gradients through the ELL kernel need the transpose "
                             "tables (ell.with_flat_tables(g, transpose=True))")
        return _EllSpmm.apply(x, g.flat, g.flat_t)
    return ell_spmm_launch(g.flat, x)
