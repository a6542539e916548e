"""CUDA flash-GAT kernels: bindings, plain versions and the dispatching
wrappers for csrc/gat_fwd.cu and csrc/gat_bwd.cu.

Port of elliptic_gnn_tpu/kernels/pallas_gat.py (flash_gat_payload) and
pallas_gat_bwd.py (flash_gat_backward3). Both kernels work on the dense
part of the attention over the BSDA tables of a 'gat' graph, on packed
rows of W = h*ch + 2h f32 columns, N_pad = num_chunks * 128 rows:

    payload  [ xp (h*ch) | a_src (h) | a_dst (h) ]
    output   [ acc (h*ch) | m (h) | s (h) ]   (acc / s with normalize)
    cotangent of the payload  [ d xp | d a_src | d a_dst ]

There is no 128-lane padding of the rows (TPU tiling). The residual spill
is merged outside (kernels/packed_gat.py).

`gat_fwd` and `gat_bwd` launch the kernel for CUDA tensors and use the
plain PyTorch version for CPU tensors, and for nothing else: a missing
compiler, a failed build or a failed launch raises. `launches` counts
kernel launches: "gat_fwd_gated" where the launch passes the per-chunk
slot cover `occ` (heads >= 2, the dispatch of the TPU package, whose
_flash_gat_call_gated it stands for), "gat_fwd" where it walks all slots
(_flash_gat_call), "gat_bwd" for the backward (_sweep_fused_call).

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
from .bsda_spmm_cuda import kernel_table
from .gat_bwd import dense_bwd_head

SOURCES = ("gat_fwd", "gat_bwd")  # csrc/<name>.cu
MAX_WIDTH = 512   # h*ch + 2h, as the TPU package's flash_eligible
MAX_DEPTH = 64    # csrc/gat_common.cuh kMaxDepth
MAX_SMEM = 232448 - 20 * 1024  # a block's shared memory less the static part

launches = {"gat_fwd": 0, "gat_fwd_gated": 0, "gat_bwd": 0}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def payload_width(h: int, ch: int) -> int:
    return h * ch + 2 * h


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        # a training step needs both: build them together at first use
        lib = ctypes.CDLL(cuda_build.build(list(SOURCES))[name])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        n_tensors = 5 if name == "gat_fwd" else 7
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = [p] * n_tensors + [i, i, i, i, i, i, f, i, p]
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def _check(g: BsdaGraph, h: int, ch: int, **tensors: torch.Tensor):
    """Validate what the kernels read; returns (A bytes, planes, pack)."""
    width = payload_width(h, ch)
    if h < 1 or ch < 1 or width > MAX_WIDTH:
        raise ValueError(f"(h, ch) = ({h}, {ch}): need h*ch + 2h <= {MAX_WIDTH}")
    if g.chunk != 128:
        raise ValueError(f"the kernels are built for 128-row chunks, not {g.chunk}")
    a, planes, pack = kernel_table(g)
    if g.depth > MAX_DEPTH or planes * 128 * 128 > MAX_SMEM:
        raise ValueError(f"depth {g.depth} in {planes} planes does not fit a "
                         "block's shared memory")
    shape = (g.num_chunks * g.chunk, width)
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
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
