"""The SAGE-ResBN hidden-layer epilogue on the GPU: binding and autograd
wrapper for csrc/resbn_epilogue.cu.

    out = dropout(relu(BN(z))) + res

from a hidden layer's SAGE convolution output z [N, C] (f32), BatchNorm
and the residual present or not (the sage_resbn, sage_bn and sage_res
variants). It replaces no Pallas kernel: XLA fused this glue on the TPU.
The plain version, the formulation that CPU tensors take and the kernels
are held against, is models/modules.py::SageResBN.epilogue_plain.

Forward, training: the column sums [n, sum z, sum z^2] (row_mask weights
the rows) in two launches (per-block partials, then a fixed-order sum of
them), all-reduced over `group` where one is given, then one apply pass
that also moves BatchNorm's running statistics in place. Eval: one apply
pass with the running statistics. The dropout's uniform draw `u` comes
from the caller (torch.rand on the model's generator), so the masks are the
generator's bits; the kernel keeps the keep mask as one byte an element
for the backward. Backward: the column sums [sum dy, sum dy * xhat] (a
BatchNorm in training, or one whose scale or bias needs a gradient), then
dz; with a group, dz takes the group's sums while the scale and bias
gradients stay the rank's own (the trainer all-reduces parameter
gradients). The residual's gradient is the output's. No float atomics:
two launches on the same inputs give the same bits.

The source is compiled with nvcc for sm_90a at first use, together with
bsda_spmm.cu (kernels/cuda_build.py), and loaded with ctypes. There is no
fallback: a CPU tensor, a missing compiler, a failed build or launch, or
an input the kernels do not take raises. Widths: a multiple of 4 up to
MAX_WIDTH columns, every [N, C] operand starting on 16 bytes (a thread
loads 4 columns at once).

`launches` counts launches by pass: "resbn_stats" (training forward's
partial sums), "resbn_finalize" (the second stage of every column sum),
"resbn_fwd" (the apply pass with batch statistics or dropout: a training
forward), "resbn_eval" (with neither), "resbn_bwd_sums" and "resbn_bwd"
(the backward's sums and dz).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from . import cuda_build

THREADS = 256               # a block's threads: a row's threads at most
MAX_WIDTH = 4 * THREADS     # four columns a thread

launches = {"resbn_stats": 0, "resbn_finalize": 0, "resbn_fwd": 0, "resbn_eval": 0,
            "resbn_bwd_sums": 0, "resbn_bwd": 0}
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        # a SAGE-ResBN step on BSDA tables needs bsda_spmm too: one parallel nvcc batch
        lib = ctypes.CDLL(cuda_build.build(("bsda_spmm", "resbn_epilogue"))["resbn_epilogue"])
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.resbn_sum_blocks.argtypes = [ll, i]
        lib.resbn_sum_blocks.restype = i
        lib.resbn_stats_launch.argtypes = [p, p, ll, i, p, p]
        lib.resbn_col_sums_launch.argtypes = [p, i, i, p, p]
        lib.resbn_apply_launch.argtypes = [p] * 7 + [f] + [p] * 6 + [ll, i, i, i, p]
        lib.resbn_bwd_sums_launch.argtypes = [p, p, p, f] + [p] * 5 + [ll, i, p, p]
        lib.resbn_bwd_launch.argtypes = [p, p, p, f] + [p] * 8 + [ll, i, i, p]
        for fn in (lib.resbn_stats_launch, lib.resbn_col_sums_launch, lib.resbn_apply_launch,
                   lib.resbn_bwd_sums_launch, lib.resbn_bwd_launch):
            fn.restype = i
        lib.resbn_error_string.argtypes = [i]
        lib.resbn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(rc: int, what: str, key: str) -> None:
    if rc != 0:
        raise RuntimeError(f"resbn_epilogue {what} launch failed: "
                           f"{_load().resbn_error_string(rc).decode()}")
    launches[key] += 1


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_inputs(z: torch.Tensor, rows=(), cols=(), row_mask=None) -> Tuple[int, int]:
    """Raises unless z is a CUDA f32 [N, C] the kernels take (N >= 1; C a
    multiple of 4 up to MAX_WIDTH) and every other operand is contiguous
    f32 on z's device: `rows` [N, C], `cols` [C], `row_mask` [N]; z and
    the `rows` start on 16 bytes. Returns (N, C)."""
    if not z.is_cuda:
        raise ValueError("the epilogue kernels take CUDA tensors; the plain version is "
                         "models/modules.py::SageResBN.epilogue_plain")
    if z.dim() != 2 or z.shape[0] < 1:
        raise ValueError(f"z must be [N, C] with N >= 1, got {tuple(z.shape)}")
    n, c = z.shape
    if c < 1 or c % 4 != 0 or c > MAX_WIDTH:
        raise ValueError(f"width {c}: the epilogue kernels take a multiple of 4 up to "
                         f"{MAX_WIDTH} columns")
    for name, t, shape in ([("z", z, (n, c))] + [("operand", t, (n, c)) for t in rows]
                           + [("column vector", t, (c,)) for t in cols]
                           + [("row_mask", row_mask, (n,))]):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")
        if t.device != z.device:
            raise ValueError(f"{name} on {t.device}, z on {z.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} of shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if len(shape) == 2 and t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must start on 16 bytes (the kernels load 4 columns "
                             "at once)")
    return n, c


def _check_vector(name: str, t: Optional[torch.Tensor], z: torch.Tensor, numel: int) -> None:
    if t is not None and (t.dtype != torch.float32 or t.device != z.device
                          or t.numel() != numel or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous f32 vector of {numel} on {z.device}")


def _column_sums(partials: torch.Tensor) -> torch.Tensor:
    blocks, width = partials.shape
    out = partials.new_empty(width)
    rc = _load().resbn_col_sums_launch(partials.data_ptr(), blocks, width, out.data_ptr(),
                                       _stream(partials))
    _check(rc, "column sums", "resbn_finalize")
    return out


def batch_stats(z: torch.Tensor, row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, sum z, sum z^2] over z's rows, each weighted by row_mask where
    given (n is then the mask's sum), as one [1 + 2C] f32 vector."""
    n, c = _check_inputs(z, row_mask=row_mask)
    lib = _load()
    blocks = lib.resbn_sum_blocks(n, c)
    partials = z.new_empty((blocks, 1 + 2 * c))
    rc = lib.resbn_stats_launch(z.data_ptr(), _ptr(row_mask), n, c, partials.data_ptr(),
                                _stream(z))
    _check(rc, "stats", "resbn_stats")
    return _column_sums(partials)


def apply(z, res=None, scale=None, bias=None, stats=None, running=None, u=None,
          keep: float = 1.0):
    """The forward's apply pass: (out, keep mask or None). BatchNorm where
    scale and bias are given: from `stats` (batch_stats) in training, the
    (mean, var, count) buffers of `running`, where given, moved in place;
    from the running mean and var without stats. Dropout where `u` (the
    uniform draw, [N, C]) is given: kept where u < keep."""
    bn = scale is not None
    if bn and (bias is None or (stats is None and running is None)):
        raise ValueError("BatchNorm needs scale, bias and the batch or running statistics")
    if u is not None and not 0.0 < keep <= 1.0:
        raise ValueError(f"keep {keep} outside (0, 1]")
    mean = var = count = None
    if running is not None:
        mean, var, count = running
    n, c = _check_inputs(z, rows=(res, u), cols=(scale, bias, mean, var))
    _check_vector("stats", stats, z, 1 + 2 * c)
    _check_vector("count", count, z, 1)
    out = torch.empty_like(z)
    keep_mask = torch.empty(z.shape, dtype=torch.uint8, device=z.device) if u is not None else None
    train = bn and stats is not None
    moved = (mean, var, count) if train else (None, None, None)
    read = (None, None) if train else (mean, var)
    rc = _load().resbn_apply_launch(
        z.data_ptr(), _ptr(stats if train else None), _ptr(read[0]), _ptr(read[1]),
        _ptr(scale), _ptr(bias), _ptr(u), float(keep), _ptr(res), out.data_ptr(),
        _ptr(keep_mask), *(_ptr(t) for t in moved), n, c, int(bn), int(res is not None),
        _stream(z))
    _check(rc, "apply", "resbn_fwd" if train or u is not None else "resbn_eval")
    return out, keep_mask


def backward_sums(g, z, scale, bias, stats=None, running=None, keep_mask=None,
                  keep: float = 1.0) -> torch.Tensor:
    """[sum dy, sum dy * xhat] (2C) over the rows, dy the cotangent of
    BatchNorm's output, with the normalisation the forward had (stats, or
    the running mean and var)."""
    n, c = _check_inputs(z, rows=(g,), cols=(scale, bias))
    mean, var = (None, None) if stats is not None else running[:2]
    lib = _load()
    blocks = lib.resbn_sum_blocks(n, c)
    partials = z.new_empty((blocks, 2 * c))
    rc = lib.resbn_bwd_sums_launch(
        g.data_ptr(), z.data_ptr(), _ptr(keep_mask), float(keep), _ptr(stats), _ptr(mean),
        _ptr(var), scale.data_ptr(), bias.data_ptr(), n, c, partials.data_ptr(),
        _stream(z))
    _check(rc, "backward sums", "resbn_bwd_sums")
    return _column_sums(partials)


def backward_dz(g, z, scale=None, bias=None, stats=None, running=None, sums=None,
                row_mask=None, keep_mask=None, keep: float = 1.0) -> torch.Tensor:
    """dz from the output's cotangent g: through BatchNorm's batch
    statistics (stats, with the group's `sums` from backward_sums and the
    rows' row_mask), its running statistics, or no BatchNorm (scale None)."""
    n, c = _check_inputs(z, rows=(g,), cols=(scale, bias), row_mask=row_mask)
    _check_vector("sums", sums, z, 2 * c)
    bn = scale is not None
    mean, var = (None, None) if stats is not None or not bn else running[:2]
    dz = torch.empty_like(z)
    rc = _load().resbn_bwd_launch(
        g.data_ptr(), z.data_ptr(), _ptr(keep_mask), float(keep), _ptr(stats), _ptr(mean),
        _ptr(var), _ptr(scale), _ptr(bias), _ptr(sums), _ptr(row_mask), dz.data_ptr(),
        n, c, int(bn), _stream(z))
    _check(rc, "backward", "resbn_bwd")
    return dz


class _Epilogue(torch.autograd.Function):
    """The epilogue with its hand-written backward (module docstring)."""

    @staticmethod
    def forward(ctx, z, res, scale, bias, running, u, keep, training, row_mask, group):
        bn = scale is not None
        stats = None
        if bn and training:
            stats = batch_stats(z, row_mask)
            if group is not None:
                dist.all_reduce(stats, group=group)
        out, keep_mask = apply(z, res, scale, bias, stats, running, u, keep)
        ctx.save_for_backward(z, scale, bias, stats, keep_mask, row_mask,
                              *(running[:2] if bn and not training else (None, None)))
        ctx.keep, ctx.group = (keep if u is not None else 1.0), group
        return out

    @staticmethod
    def backward(ctx, grad):
        z, scale, bias, stats, keep_mask, row_mask, rmean, rvar = ctx.saved_tensors
        g = grad.contiguous()
        need_z, need_res, need_scale, need_bias = ctx.needs_input_grad[:4]
        running = (rmean, rvar)
        dz = dscale = dbias = sums = None
        c = z.shape[1]
        if scale is not None and (stats is not None and need_z or need_scale or need_bias):
            sums = backward_sums(g, z, scale, bias, stats, running, keep_mask, ctx.keep)
            dbias, dscale = sums[:c], sums[c:]
        if need_z:
            group_sums = sums
            if stats is not None and ctx.group is not None:
                group_sums = sums.clone()
                dist.all_reduce(group_sums, group=ctx.group)
            dz = backward_dz(g, z, scale, bias, stats, running, group_sums, row_mask,
                             keep_mask, ctx.keep)
        return (dz, g if need_res else None, dscale if need_scale else None,
                dbias if need_bias else None, None, None, None, None, None, None)


def resbn_epilogue(z: torch.Tensor, res: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                   running=None, u: Optional[torch.Tensor] = None, keep: float = 1.0,
                   training: bool = False, row_mask: Optional[torch.Tensor] = None,
                   group=None) -> torch.Tensor:
    """dropout(relu(BN(z))) + res through the kernels, differentiable.

    BatchNorm where `scale` and `bias` are given, with `running` its
    (mean, var, count) buffers: in `training` over the batch statistics
    (rows weighted by `row_mask`, summed over the process `group`), the
    buffers moved in place; else with the running mean and var. Dropout
    where `u` is given (kept where u < keep, scaled by 1 / keep). The
    residual `res` is added where given."""
    if scale is not None and running is None:
        raise ValueError("BatchNorm needs its running statistics")
    return _Epilogue.apply(z, res, scale, bias, running, u, float(keep), bool(training),
                           row_mask, group)
