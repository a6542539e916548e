"""CUDA flash-GAT kernels: bindings, plain versions and the dispatching
wrappers for csrc/gat_fwd.cu, gat_bwd.cu, gat_bwd_dst.cu and gat_bwd_src.cu.

Port of elliptic_gnn_tpu/kernels/pallas_gat.py (flash_gat_payload) and
pallas_gat_bwd.py (flash_gat_backward3, flash_gat_backward). The kernels
work on the dense part of the attention over the BSDA tables of a 'gat'
graph, on packed rows of W = h*ch + 2h f32 columns, N_pad = num_chunks *
128 rows:

    payload  [ xp (h*ch) | a_src (h) | a_dst (h) ]
    output   [ acc (h*ch) | m (h) | s (h) ]   (acc / s with normalize)
    cotangent of the payload  [ d xp | d a_src | d a_dst ]
    grad payload G2  [ A_bar (h*ch) | S_bar (h) | a_dst (h) | m (h) ]

There is no 128-lane padding of the rows (TPU tiling). The residual spill
is merged outside (kernels/packed_gat.py).

Two backwards compute the same cotangent. `gat_bwd` is one sweep over the
forward tables that sums the per-source columns with f32 atomics, so their
last bits vary from run to run. `gat_bwd_two_sweep` builds G2
(kernels/gat_bwd.py::grad_payload) and runs a destination sweep over the
forward tables and a source sweep over g.transpose
(kernels/bsda.py::gat_block_transpose): every output is summed by the one
warp that owns its row, in a fixed order, so two runs give the same bits.

`gat_fwd`, `gat_bwd` and `gat_bwd_two_sweep` launch the kernels for CUDA
tensors and use the plain PyTorch versions for CPU tensors, and for
nothing else: a missing compiler, a failed build or a failed launch raises.
`launches` counts kernel launches: "gat_fwd_gated" where the launch passes
the per-chunk slot cover `occ` (heads >= 2, the dispatch of the TPU
package, whose _flash_gat_call_gated it stands for), "gat_fwd" where it
walks all slots (_flash_gat_call), "gat_bwd" for the one-sweep backward
(_sweep_fused_call), "gat_bwd_dst" and "gat_bwd_src" for the two sweeps
(_sweep_dst_call, _sweep_src_call).

The softmax shift m differs between implementations (the kernel and the
plain version take the exact row max over the row's edges, the TPU kernels
an upper bound): compare acc / s and m + log s, never m or s alone.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import cuda_build
from .bsda import BsdaGraph
from .bsda_gat import dense_part
from .bsda_spmm_cuda import MAX_ROWS, kernel_table
from .gat_bwd import dense_bwd_head, grad_payload, sweep_dst_head, sweep_src_head

SOURCES = ("gat_fwd", "gat_bwd", "gat_bwd_dst", "gat_bwd_src")  # csrc/<name>.cu
MAX_WIDTH = 512   # h*ch + 2h, as the TPU package's flash_eligible
MAX_DEPTH = 64    # csrc/gat_common.cuh kMaxDepth
MAX_SMEM = 232448 - 20 * 1024  # a block's shared memory less the static part
PLANE_BYTES = 128 * 128           # a staged plane (gat_common.cuh kPlaneBytes)
COLUMN_PLANE_BYTES = 128 * 33 * 4  # with rows padded to 33 words (kColPlaneWords)

launches = {"gat_fwd": 0, "gat_fwd_gated": 0, "gat_bwd": 0,
            "gat_bwd_dst": 0, "gat_bwd_src": 0}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def payload_width(h: int, ch: int) -> int:
    return h * ch + 2 * h


def g2_width(h: int, ch: int) -> int:
    return h * ch + 3 * h


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        # a training step needs several: build them together at first use
        lib = ctypes.CDLL(cuda_build.build(list(SOURCES))[name])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # tables and tensors; six sizes; slope; (normalize;) stream
        tensors, flag = {"gat_fwd": (5, [i]), "gat_bwd": (7, [i]),
                         "gat_bwd_dst": (6, []), "gat_bwd_src": (6, [])}[name]
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = [p] * tensors + [i] * 6 + [f] + flag + [p]
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def _check(g: BsdaGraph, h: int, ch: int, plane_bytes: int = PLANE_BYTES,
           **tensors: torch.Tensor):
    """Validate what the kernels read; returns (A bytes, planes, pack).
    Every tensor is [N_pad, W] but the one named g2, [N_pad, h*ch + 3h]."""
    width = payload_width(h, ch)
    if h < 1 or ch < 1 or width > MAX_WIDTH:
        raise ValueError(f"(h, ch) = ({h}, {ch}): need h*ch + 2h <= {MAX_WIDTH}")
    if g.chunk != 128:
        raise ValueError(f"the kernels are built for 128-row chunks, not {g.chunk}")
    a, planes, pack = kernel_table(g)
    if g.num_chunks * g.chunk > MAX_ROWS:
        raise ValueError(f"{g.num_chunks * g.chunk} rows: the forward kernel's edge "
                         f"list takes {MAX_ROWS}")
    if g.depth > MAX_DEPTH or planes * plane_bytes > MAX_SMEM:
        raise ValueError(f"depth {g.depth} in {planes} planes does not fit a "
                         "block's shared memory")
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        shape = (g.num_chunks * g.chunk,
                 g2_width(h, ch) if name == "g2" else width)
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError("tensors lie on different devices")
    for t in (a, g.src_chunk, g.slot_occ):
        if t.device != first.device:
            raise ValueError(f"BSDA tables on {t.device}, payload on {first.device}")
        if not t.is_contiguous():
            raise ValueError("BSDA tables must be contiguous")
    if tuple(a.shape) != (g.num_chunks, planes, 128, 128) or a.data_ptr() % 16:
        raise ValueError(f"A table of shape {tuple(a.shape)} is not the "
                         f"16-byte-aligned [B, planes, 128, 128] the kernels read")
    if g.src_chunk.dtype != torch.int32 or g.slot_occ.dtype != torch.int32:
        raise ValueError("src_chunk and slot_occ must be int32")
    return a, planes, pack


def _launch_sweep(name: str, g: BsdaGraph, first: torch.Tensor,
                  second: torch.Tensor, ct: torch.Tensor, tables, h: int,
                  ch: int, negative_slope: float) -> None:
    """Launch one of the two sweeps over g's tables (a, planes, pack)."""
    a, planes, pack = tables
    lib = _load(name)
    with torch.cuda.device(ct.device):
        rc = getattr(lib, f"{name}_launch")(
            a.data_ptr(), g.src_chunk.data_ptr(), g.slot_occ.data_ptr(),
            first.data_ptr(), second.data_ptr(), ct.data_ptr(), g.num_chunks,
            g.depth, planes, pack, h, ch, float(negative_slope),
            torch.cuda.current_stream(ct.device).cuda_stream)
    if rc != 0:
        err = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {err}")
    launches[name] += 1


def gat_fwd_cuda(g: BsdaGraph, payload: torch.Tensor, h: int, ch: int,
                 negative_slope: float = 0.2, normalize: bool = False,
                 gated: Optional[bool] = None) -> torch.Tensor:
    """The forward kernel: payload [N_pad, W] -> [ acc | m | s ] (acc / s
    in the acc columns with `normalize`). `gated` passes the slot cover
    occ; None means the TPU package's rule, heads >= 2."""
    a, planes, pack = _check(g, h, ch, payload=payload)
    gated = h >= 2 if gated is None else gated
    out = torch.empty_like(payload)
    lib = _load("gat_fwd")
    with torch.cuda.device(payload.device):
        rc = lib.gat_fwd_launch(
            a.data_ptr(), g.src_chunk.data_ptr(),
            g.slot_occ.data_ptr() if gated else None, payload.data_ptr(),
            out.data_ptr(), g.num_chunks, g.depth, planes, pack, h, ch,
            float(negative_slope), int(bool(normalize)),
            torch.cuda.current_stream(payload.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"gat_fwd launch failed: {lib.gat_fwd_error_string(rc).decode()}")
    launches["gat_fwd_gated" if gated else "gat_fwd"] += 1
    return out


def gat_bwd_cuda(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
                 out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
                 normalized: bool) -> torch.Tensor:
    """The backward kernel: cotangent `gbar` of the forward's output
    `out_k` = gat_fwd(payload, normalize=normalized) -> cotangent of the
    payload [ d xp | d a_src | d a_dst ]. The per-source columns are summed
    with f32 atomics: their last bits vary from run to run."""
    a, planes, pack = _check(g, h, ch, gbar=gbar, payload=payload, out_k=out_k)
    ct = torch.zeros_like(payload)
    lib = _load("gat_bwd")
    with torch.cuda.device(payload.device):
        rc = lib.gat_bwd_launch(
            a.data_ptr(), g.src_chunk.data_ptr(), g.slot_occ.data_ptr(),
            gbar.data_ptr(), payload.data_ptr(), out_k.data_ptr(), ct.data_ptr(),
            g.num_chunks, g.depth, planes, pack, h, ch, float(negative_slope),
            int(bool(normalized)),
            torch.cuda.current_stream(payload.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"gat_bwd launch failed: {lib.gat_bwd_error_string(rc).decode()}")
    launches["gat_bwd"] += 1
    return ct


def gat_bwd_dst_cuda(g: BsdaGraph, g2: torch.Tensor, payload: torch.Tensor,
                     h: int, ch: int, negative_slope: float,
                     ct: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The destination sweep over the forward tables `g`: grad payload `g2`
    (own rows) and the forward's `payload` (streamed rows) -> the d a_dst
    columns of the payload's cotangent, written into `ct` [N_pad, W] (a
    zeroed one when None; its other columns are left as they are)."""
    ct = torch.zeros_like(payload) if ct is None else ct
    tables = _check(g, h, ch, g2=g2, payload=payload, ct=ct)
    _launch_sweep("gat_bwd_dst", g, g2, payload, ct, tables, h, ch, negative_slope)
    return ct


def gat_bwd_src_cuda(g_t: BsdaGraph, payload: torch.Tensor, g2: torch.Tensor,
                     h: int, ch: int, negative_slope: float,
                     ct: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The source sweep over the transpose tables `g_t`: the forward's
    `payload` (own rows) and grad payload `g2` (streamed rows) -> the d xp
    and d a_src columns of the payload's cotangent, written into `ct`
    [N_pad, W] (a zeroed one when None; its d a_dst columns are left as
    they are)."""
    ct = torch.zeros_like(payload) if ct is None else ct
    tables = _check(g_t, h, ch, plane_bytes=COLUMN_PLANE_BYTES, payload=payload,
                    g2=g2, ct=ct)
    _launch_sweep("gat_bwd_src", g_t, payload, g2, ct, tables, h, ch, negative_slope)
    return ct


# ---------------- plain PyTorch versions ----------------

def _split(t: torch.Tensor, h: int, ch: int):
    """Packed rows -> ([N, h, ch], [N, h], [N, h])."""
    hc = h * ch
    return t[:, :hc].reshape(-1, h, ch), t[:, hc: hc + h], t[:, hc + h: hc + 2 * h]


def gat_fwd_plain(g: BsdaGraph, payload: torch.Tensor, h: int, ch: int,
                  negative_slope: float = 0.2,
                  normalize: bool = False) -> torch.Tensor:
    """Plain version of the forward kernel: the dense part of
    kernels/bsda_gat.py per head, packed as the kernel packs it."""
    xp, asrc, adst = _split(payload, h, ch)
    parts = [dense_part(g, xp[:, k, :], asrc[:, k], adst[:, k], negative_slope)
             for k in range(h)]
    m = torch.stack([p[0].reshape(-1) for p in parts], dim=1)
    s = torch.stack([p[1].reshape(-1) for p in parts], dim=1)
    acc = torch.stack([p[2].reshape(-1, ch) for p in parts], dim=1)
    if normalize:
        acc = acc / s.clamp_min(1e-16)[..., None]
    return torch.cat([acc.reshape(-1, h * ch), m, s], dim=1)


def gat_bwd_plain(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
                  out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
                  normalized: bool) -> torch.Tensor:
    """Plain version of the backward kernel: the closed form of
    kernels/gat_bwd.py per head, in the kernel's packed interface."""
    xp, asrc, adst = _split(payload, h, ch)
    abar, _, sbar = _split(gbar, h, ch)
    val, m, s = _split(out_k, h, ch)
    if normalized:
        inv_s = 1.0 / s.clamp_min(1e-16)
        sbar = sbar - (abar * val).sum(dim=-1) * inv_s
        abar = abar * inv_s[..., None]
    outs = [dense_bwd_head(g, xp[:, k, :], asrc[:, k], adst[:, k], m[:, k],
                           abar[:, k, :], sbar[:, k], negative_slope)
            for k in range(h)]
    return torch.cat(
        [torch.stack([o[0] for o in outs], dim=1).reshape(-1, h * ch),
         torch.stack([o[1] for o in outs], dim=1),
         torch.stack([o[2] for o in outs], dim=1)], dim=1)


def _split_g2(g2: torch.Tensor, h: int, ch: int):
    """G2 rows -> (A_bar [N, h, ch], S_bar, a_dst, m [N, h])."""
    hc = h * ch
    return (g2[:, :hc].reshape(-1, h, ch), g2[:, hc: hc + h],
            g2[:, hc + h: hc + 2 * h], g2[:, hc + 2 * h: hc + 3 * h])


def gat_bwd_dst_plain(g: BsdaGraph, g2: torch.Tensor, payload: torch.Tensor,
                      h: int, ch: int, negative_slope: float) -> torch.Tensor:
    """Plain version of the destination sweep: kernels/gat_bwd.py's
    sweep_dst_head per head over the forward tables; [N_pad, W] with the
    d a_dst columns filled and zeros elsewhere."""
    xp, asrc, _ = _split(payload, h, ch)
    abar, sbar, adst, m = _split_g2(g2, h, ch)
    ct = torch.zeros_like(payload)
    ct[:, h * ch + h:] = torch.stack(
        [sweep_dst_head(g, xp[:, k, :], asrc[:, k], abar[:, k, :], sbar[:, k],
                        adst[:, k], m[:, k], negative_slope) for k in range(h)], dim=1)
    return ct


def gat_bwd_src_plain(g_t: BsdaGraph, payload: torch.Tensor, g2: torch.Tensor,
                      h: int, ch: int, negative_slope: float) -> torch.Tensor:
    """Plain version of the source sweep: kernels/gat_bwd.py's
    sweep_src_head per head over the transpose tables; [N_pad, W] with the
    d xp and d a_src columns filled and zeros in the d a_dst columns."""
    xp, asrc, _ = _split(payload, h, ch)
    abar, sbar, adst, m = _split_g2(g2, h, ch)
    outs = [sweep_src_head(g_t, xp[:, k, :], asrc[:, k], abar[:, k, :], sbar[:, k],
                           adst[:, k], m[:, k], negative_slope) for k in range(h)]
    return torch.cat(
        [torch.stack([o[0] for o in outs], dim=1).reshape(-1, h * ch),
         torch.stack([o[1] for o in outs], dim=1),
         payload.new_zeros((payload.shape[0], h))], dim=1)


# ---------------- dispatch ----------------

def gat_fwd(g: BsdaGraph, payload: torch.Tensor, h: int, ch: int,
            negative_slope: float = 0.2, normalize: bool = False) -> torch.Tensor:
    """The kernel for a CUDA payload, the plain version for a CPU one."""
    if payload.is_cuda:
        return gat_fwd_cuda(g, payload, h, ch, negative_slope, normalize)
    return gat_fwd_plain(g, payload, h, ch, negative_slope, normalize)


def gat_bwd(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
            out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
            normalized: bool) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if payload.is_cuda:
        return gat_bwd_cuda(g, gbar, payload, out_k, h, ch, negative_slope,
                            normalized)
    return gat_bwd_plain(g, gbar, payload, out_k, h, ch, negative_slope,
                         normalized)


def gat_bwd_two_sweep(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
                      out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
                      normalized: bool) -> torch.Tensor:
    """The same cotangent as gat_bwd, bit-reproducible: G2 from
    grad_payload, then the destination sweep over g and the source sweep
    over g.transpose, each writing its own columns. The kernels for CUDA
    tensors, the plain versions for CPU ones; without transpose tables it
    raises."""
    if g.transpose is None:
        raise ValueError(
            "the two-sweep GAT backward needs the transpose tables: build the "
            "graph with build_bsda_for_kind(..., 'gat', transpose=True)")
    g2 = grad_payload(gbar, payload, out_k, h, ch, normalized)
    if payload.is_cuda:
        ct = torch.empty_like(payload)  # the sweeps write every column
        gat_bwd_dst_cuda(g, g2, payload, h, ch, negative_slope, ct=ct)
        return gat_bwd_src_cuda(g.transpose, payload, g2, h, ch, negative_slope,
                                ct=ct)
    return (gat_bwd_dst_plain(g, g2, payload, h, ch, negative_slope)
            + gat_bwd_src_plain(g.transpose, payload, g2, h, ch, negative_slope))
