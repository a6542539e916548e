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
last bits vary from run to run. `gat_bwd_two_sweep` runs a destination
sweep over the forward tables, which also writes G2 (the cotangents in the
raw gauge, kernels/gat_bwd.py::grad_payload), and a source sweep over
g.transpose (kernels/bsda.py::gat_block_transpose, planes stored
transposed) that reads it: every output is summed by the one thread group
that owns its row, in a fixed order, so two runs give the same bits.

A rectangular launch (`dst_row0`) runs a run of destination chunks over a
payload of more rows than the grid's: g's chunks are a slice whose
src_chunk ids index every payload row, their own rows are payload rows
dst_row0 ... (their a_dst is read there, their d a_dst written there), and
the grid's own tensors (the forward's output, gbar, out_k, G2) hold the
grid's rows. One rank's rows under the GSPMD row sharding, or one shard's
over its halo-extended rows (parallel/). The source sweep's rectangular
launch runs a run of SOURCE chunks (payload and ct rows dst_row0 ...) over
every G2 row its tables index. The whole graph is dst_row0 = 0 with the
payload's rows the grid's.

The four kernels walk per-chunk edge lists (csrc/bsda_edges.cuh); each
launch fixes its plan (copy width, list size, gather batch and stride,
thread group) in the C launch function, and the wrappers raise where a list
cannot fit a block: depth above 256, or more shared memory than a block
has, or more than 2^24 rows. A launch takes packed rows of at most
MAX_WIDTH columns; wider (h, ch) are split into launches by `width_tiles`
(heads are independent): groups of whole heads, or for a head with ch + 2
> MAX_WIDTH, column tiles of it, which share its a_src and a_dst. The
backwards run column tiles in the raw gauge, A_bar and S_bar taken once
from the whole row (grad_payload), with S_bar on a head's first tile only,
and add the tiles' d a_src and d a_dst in tile order (the head dot
xp_j . A_i spans the tiles). The `*_tiled` functions take the launch
as an argument, so that the plain versions can drive them too.

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
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import cuda_build
from .bsda import BsdaGraph
from .bsda_gat import dense_part
from .bsda_spmm_cuda import MAX_ROWS, kernel_table
from .gat_bwd import dense_bwd_head, grad_payload, sweep_dst_head, sweep_src_head

SOURCES = ("gat_fwd", "gat_bwd", "gat_bwd_dst", "gat_bwd_src")  # csrc/<name>.cu
MAX_WIDTH = 512   # h*ch + 2h of one launch, as the TPU package's flash_eligible
MAX_SMEM = 232448  # a block's shared memory on sm_90
# an item keeps its plane in 8 bits; a list holds max(128 * depth, 2048)
# edges of 4 bytes and as many 8-byte items, beside two 20 KB gather
# buffers, the offsets and src_chunk (csrc/bsda_edges.cuh)
LIST_MAX_DEPTH = 256
HEAD_SUM_BYTES = 256 * 16 * 4  # the backwards' head-sum rows, at most

launches = {"gat_fwd": 0, "gat_fwd_gated": 0, "gat_bwd": 0,
            "gat_bwd_dst": 0, "gat_bwd_src": 0}
_libs: Dict[str, ctypes.CDLL] = {}


def payload_width(h: int, ch: int) -> int:
    return h * ch + 2 * h


def g2_width(h: int, ch: int) -> int:
    return h * ch + 3 * h


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        # a training step needs several: build them together at first use
        lib = ctypes.CDLL(cuda_build.build(list(SOURCES))[name])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # tables and tensors; six sizes; (n_rows, dst_row0;) slope;
        # (normalize;) stream
        tensors, flag = {"gat_fwd": (5, [i]), "gat_bwd": (7, [i]),
                         "gat_bwd_dst": (8, [i]), "gat_bwd_src": (6, [])}[name]
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = [p] * tensors + [i] * 6 + [f] + flag + [p]
        launch.restype = ctypes.c_int
        rect = getattr(lib, f"{name}_launch_rect", None)  # absent from older sources
        if rect is not None:
            rect.argtypes = [p] * tensors + [i] * 8 + [f] + flag + [p]
            rect.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def _edge_list_smem(depth: int, extra: int) -> int:
    """Shared memory of a block of the edge-list kernels at `depth`, at
    most, with `extra` bytes beside the list and the gather buffers
    (csrc/bsda_edges.cuh list_bytes and buffer_area)."""
    cap = max(128 * depth, 2048)
    return max(2 * 20480, 8 * cap) + extra + 4 * cap + 4 * (2 * 129 + 18 + depth + 3)


def _check(g: BsdaGraph, h: int, ch: int, extra: int = 0, **tensors):
    """Validate what one launch reads; returns (A bytes, planes, pack).
    `tensors`: name -> (tensor, rows), each [rows, W] but the one named g2,
    [rows, h*ch + 3h]. `extra`: bytes of shared memory of the kernel's own,
    beside the edge list's."""
    width = payload_width(h, ch)
    if h < 1 or ch < 1 or width > MAX_WIDTH:
        raise ValueError(f"(h, ch) = ({h}, {ch}): a launch takes h*ch + 2h <= {MAX_WIDTH}")
    if g.chunk != 128:
        raise ValueError(f"the kernels are built for 128-row chunks, not {g.chunk}")
    a, planes, pack = kernel_table(g)
    if g.num_chunks * g.chunk > MAX_ROWS:
        raise ValueError(f"{g.num_chunks * g.chunk} rows: the kernels' edge "
                         f"lists take {MAX_ROWS}")
    if g.depth > LIST_MAX_DEPTH or _edge_list_smem(g.depth, extra) > MAX_SMEM:
        raise ValueError(f"depth {g.depth}: one row's edge list does not fit a "
                         "block's shared memory")
    first = next(iter(tensors.values()))[0]
    for name, (t, rows) in tensors.items():
        shape = (rows, g2_width(h, ch) if name == "g2" else width)
        if rows > MAX_ROWS:
            raise ValueError(f"{name} has {rows} rows: the kernels' edge lists "
                             f"take {MAX_ROWS}")
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


def _run(name: str, device: torch.device, ptrs, sizes, rect, tail,
         counted: Optional[str] = None) -> None:
    """Calls csrc/<name>.cu's launch on `device`'s current stream: with
    `rect` = (n_rows, dst_row0) <name>_launch_rect(*ptrs, *sizes, *rect,
    *tail, stream), or the whole graph's <name>_launch where rect is
    (grid rows, 0); counts the launch under `counted` (default `name`)."""
    lib = _load(name)
    whole = rect == (sizes[0] * 128, 0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if whole:
            rc = getattr(lib, f"{name}_launch")(*ptrs, *sizes, *tail, stream)
        else:
            rc = getattr(lib, f"{name}_launch_rect")(*ptrs, *sizes, *rect, *tail, stream)
    if rc != 0:
        err = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {err}")
    launches[counted or name] += 1


def _tables(g: BsdaGraph, planes: int, pack: int, h: int, ch: int):
    return (g.num_chunks, g.depth, planes, pack, h, ch)


def _grid_rows(g: BsdaGraph) -> int:
    return g.num_chunks * g.chunk


def _payload_rows(g: BsdaGraph, payload: torch.Tensor, dst_row0: int) -> int:
    """The payload's rows, which must hold the grid's own rows from
    dst_row0 on."""
    _own_rows(payload, dst_row0, _grid_rows(g))
    return payload.shape[0]


def _fwd_launch(g: BsdaGraph, payload: torch.Tensor, h: int, ch: int,
                negative_slope: float, normalize: bool, gated: bool,
                dst_row0: int = 0) -> torch.Tensor:
    rows = _payload_rows(g, payload, dst_row0)
    a, planes, pack = _check(g, h, ch, extra=128 * 4 * h, payload=(payload, rows))
    out = payload.new_empty((_grid_rows(g), payload.shape[1]))
    _run("gat_fwd", payload.device,
         (a.data_ptr(), g.src_chunk.data_ptr(), g.slot_occ.data_ptr() if gated else None,
          payload.data_ptr(), out.data_ptr()), _tables(g, planes, pack, h, ch),
         (rows, dst_row0), (float(negative_slope), int(bool(normalize))),
         counted="gat_fwd_gated" if gated else "gat_fwd")
    return out


def _bwd_launch(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
                out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
                normalized: bool, dst_row0: int = 0) -> torch.Tensor:
    rows = _payload_rows(g, payload, dst_row0)
    ct = torch.zeros_like(payload)
    a, planes, pack = _check(g, h, ch, extra=HEAD_SUM_BYTES, gbar=(gbar, _grid_rows(g)),
                             payload=(payload, rows), out_k=(out_k, _grid_rows(g)),
                             ct=(ct, rows))
    _run("gat_bwd", payload.device,
         (a.data_ptr(), g.src_chunk.data_ptr(), g.slot_occ.data_ptr(),
          gbar.data_ptr(), payload.data_ptr(), out_k.data_ptr(), ct.data_ptr()),
         _tables(g, planes, pack, h, ch), (rows, dst_row0),
         (float(negative_slope), int(bool(normalized))))
    return ct


def _dst_launch(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
                out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
                normalized: bool, ct: Optional[torch.Tensor] = None,
                dst_row0: int = 0):
    rows = _payload_rows(g, payload, dst_row0)
    ct = torch.zeros_like(payload) if ct is None else ct
    g2 = payload.new_empty((_grid_rows(g), g2_width(h, ch)))
    a, planes, pack = _check(g, h, ch, extra=HEAD_SUM_BYTES, gbar=(gbar, _grid_rows(g)),
                             payload=(payload, rows), out_k=(out_k, _grid_rows(g)),
                             ct=(ct, rows), g2=(g2, _grid_rows(g)))
    _run("gat_bwd_dst", payload.device,
         (a.data_ptr(), g.src_chunk.data_ptr(), g.slot_occ.data_ptr(),
          gbar.data_ptr(), payload.data_ptr(), out_k.data_ptr(), ct.data_ptr(),
          g2.data_ptr()), _tables(g, planes, pack, h, ch), (rows, dst_row0),
         (float(negative_slope), int(bool(normalized))))
    return ct, g2


def _src_launch(g_t: BsdaGraph, payload: torch.Tensor, g2: torch.Tensor, h: int,
                ch: int, negative_slope: float,
                ct: Optional[torch.Tensor] = None, dst_row0: int = 0) -> torch.Tensor:
    rows = _payload_rows(g_t, payload, dst_row0)
    ct = torch.zeros_like(payload) if ct is None else ct
    a, planes, pack = _check(g_t, h, ch, extra=HEAD_SUM_BYTES, payload=(payload, rows),
                             g2=(g2, g2.shape[0]), ct=(ct, rows))
    _run("gat_bwd_src", payload.device,
         (a.data_ptr(), g_t.src_chunk.data_ptr(), g_t.slot_occ.data_ptr(),
          payload.data_ptr(), g2.data_ptr(), ct.data_ptr()),
         _tables(g_t, planes, pack, h, ch), (g2.shape[0], dst_row0),
         (float(negative_slope),))
    return ct


def gat_fwd_cuda(g: BsdaGraph, payload: torch.Tensor, h: int, ch: int,
                 negative_slope: float = 0.2, normalize: bool = False,
                 gated: Optional[bool] = None, dst_row0: int = 0) -> torch.Tensor:
    """The forward kernel: payload [N_pad, W] -> [ acc | m | s ] (acc / s
    in the acc columns with `normalize`), or with `dst_row0` the
    rectangular launch: g's destination chunks from payload row dst_row0
    on, [grid rows, W] out. `gated` passes the slot cover occ; None means
    the TPU package's rule, heads >= 2."""
    gated = h >= 2 if gated is None else gated
    return gat_fwd_tiled(
        lambda p, hh, cc, nm: _fwd_launch(g, p, hh, cc, negative_slope, nm, gated,
                                          dst_row0),
        payload, h, ch, normalize)


def gat_bwd_cuda(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
                 out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
                 normalized: bool, dst_row0: int = 0) -> torch.Tensor:
    """The backward kernel: cotangent `gbar` of the forward's output
    `out_k` = gat_fwd(payload, normalize=normalized) -> cotangent of the
    payload [ d xp | d a_src | d a_dst ] over the payload's rows (with
    `dst_row0`, the rectangular form: gbar and out_k the grid's rows). The
    per-source columns are summed with f32 atomics: their last bits vary
    from run to run."""
    return gat_bwd_tiled(
        lambda gb, p, o, hh, cc, nm: _bwd_launch(g, gb, p, o, hh, cc, negative_slope, nm,
                                                 dst_row0),
        gbar, payload, out_k, h, ch, normalized, dst_row0=dst_row0)


def gat_bwd_dst_cuda(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
                     out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
                     normalized: bool, ct: Optional[torch.Tensor] = None,
                     dst_row0: int = 0):
    """The destination sweep over the forward tables `g`, grad payload
    included: the forward's `payload` and output `out_k`, and the cotangent
    `gbar` of that output -> (ct, g2): the d a_dst columns of the grid's
    rows (payload rows dst_row0 ...) written into `ct`, the payload's shape
    (a zeroed one when None; its other entries are left as they are), and
    G2 [grid rows, h*ch + 3h]."""
    return gat_bwd_dst_tiled(
        lambda gb, p, o, hh, cc, nm, c: _dst_launch(g, gb, p, o, hh, cc,
                                                    negative_slope, nm, c, dst_row0),
        gbar, payload, out_k, h, ch, normalized, ct, dst_row0=dst_row0)


def gat_bwd_src_cuda(g_t: BsdaGraph, payload: torch.Tensor, g2: torch.Tensor,
                     h: int, ch: int, negative_slope: float,
                     ct: Optional[torch.Tensor] = None, dst_row0: int = 0) -> torch.Tensor:
    """The source sweep over the transpose tables `g_t`: the forward's
    `payload` (own rows: payload rows dst_row0 ..., g_t's grid) and the
    grad payload `g2` (streamed rows: every row g_t's ids index) -> the d xp
    and d a_src columns of the own rows written into `ct`, the payload's
    shape (a zeroed one when None; its other entries are left as they
    are)."""
    return gat_bwd_src_tiled(
        lambda p, g2_, hh, cc, c: _src_launch(g_t, p, g2_, hh, cc, negative_slope, c,
                                              dst_row0),
        payload, g2, h, ch, ct)


# ---------------- launches of packed rows wider than MAX_WIDTH ----------------

Tile = Tuple[int, int, int, int]  # (first head, heads, first column in a head, columns)


def width_tiles(h: int, ch: int, max_width: int = MAX_WIDTH) -> List[Tile]:
    """The launches that cover (h, ch) in packed rows of at most
    `max_width` columns: all heads at once where they fit; else groups of
    whole heads, as even as they go; else, for a head with ch + 2 >
    max_width, column tiles of every head, as even as they go and in whole
    runs of 4 columns where ch allows (the kernels' 16-byte path)."""
    if payload_width(h, ch) <= max_width:
        return [(0, h, 0, ch)]
    per = max_width // (ch + 2)
    if per >= 1:
        n = -(-h // per)
        size = -(-h // n)
        return [(k0, min(size, h - k0), 0, ch) for k0 in range(0, h, size)]
    cap = max_width - 2
    if cap < 1:
        raise ValueError(f"no tile of one column fits {max_width} columns")
    runs4 = ch % 4 == 0 and cap >= 4
    if runs4:
        cap -= cap % 4
    n = -(-ch // cap)
    size = -(-ch // n)
    if runs4:
        size = -(-size // 4) * 4
    return [(k, 1, c0, min(size, ch - c0)) for k in range(h) for c0 in range(0, ch, size)]


def _tile_index(h: int, ch: int, tile: Tile, blocks: int, device) -> torch.Tensor:
    """Columns of packed rows [ h*ch | `blocks` blocks of h ] that a tile's
    packed rows [ K*C | `blocks` blocks of K ] take, in their order."""
    k0, k, c0, c = tile
    heads = torch.arange(k0, k0 + k, device=device)
    cols = (heads[:, None] * ch + c0 + torch.arange(c, device=device)[None, :]).reshape(-1)
    return torch.cat([cols] + [h * ch + j * h + heads for j in range(blocks)])


def _check_width(h: int, ch: int, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        width = g2_width(h, ch) if name == "g2" else payload_width(h, ch)
        if t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"{name} must be [N_pad, {width}] at (h, ch) = ({h}, {ch}), "
                             f"got {tuple(t.shape)}")


def _raw_gauge(tiles: List[Tile], gbar, payload, out_k, h, ch, normalized,
               dst_row0: int = 0):
    """Column tiles of a head need the head's (A_bar, S_bar) from the whole
    row: for them a cotangent in the raw gauge [ A_bar | 0 | S_bar ], and
    normalized False; whole heads keep theirs. The grid's own rows are
    payload rows dst_row0 ..."""
    if tiles[0][3] == ch:
        return gbar, normalized
    hc = h * ch
    g2 = grad_payload(gbar, _own_rows(payload, dst_row0, gbar.shape[0]), out_k, h, ch,
                      normalized)
    return torch.cat([g2[:, :hc], torch.zeros_like(g2[:, hc: hc + h]),
                      g2[:, hc: hc + h]], dim=1), False


def _first_tile_only(sub: torch.Tensor, tile: Tile, column: int) -> torch.Tensor:
    """S_bar (the K columns from `column` on) to a head's first column tile
    only: the term S_i of q + S_i is the head's, not the tile's."""
    if tile[2] > 0:
        sub[:, column: column + tile[1]] = 0.0
    return sub


def gat_fwd_tiled(launch: Callable, payload: torch.Tensor, h: int, ch: int,
                  normalize: bool, max_width: int = MAX_WIDTH) -> torch.Tensor:
    """The forward in launches of at most `max_width` columns;
    launch(payload, h, ch, normalize) runs one (the output has the grid's
    rows). Column tiles of a head give the same m and s (they depend on
    a_src and a_dst only)."""
    tiles = width_tiles(h, ch, max_width)
    if len(tiles) == 1:
        return launch(payload, h, ch, normalize)
    _check_width(h, ch, payload=payload)
    out = None
    for tile in tiles:
        idx = _tile_index(h, ch, tile, 2, payload.device)
        part = launch(payload[:, idx], tile[1], tile[3], normalize)
        if out is None:
            out = payload.new_empty((part.shape[0], payload.shape[1]))
        out[:, idx] = part
    return out


def gat_bwd_tiled(launch: Callable, gbar: torch.Tensor, payload: torch.Tensor,
                  out_k: torch.Tensor, h: int, ch: int, normalized: bool,
                  max_width: int = MAX_WIDTH, dst_row0: int = 0) -> torch.Tensor:
    """The one-sweep backward in launches of at most `max_width` columns;
    launch(gbar, payload, out_k, h, ch, normalized) runs one (the grid's own
    rows are payload rows dst_row0 ...). d a_src and d a_dst of a head's
    column tiles are added in tile order."""
    tiles = width_tiles(h, ch, max_width)
    if len(tiles) == 1:
        return launch(gbar, payload, out_k, h, ch, normalized)
    _check_width(h, ch, gbar=gbar, payload=payload, out_k=out_k)
    gbar, normalized = _raw_gauge(tiles, gbar, payload, out_k, h, ch, normalized,
                                  dst_row0)
    ct = torch.zeros_like(payload)
    for tile in tiles:
        idx = _tile_index(h, ch, tile, 2, payload.device)
        kc = tile[1] * tile[3]
        part = launch(_first_tile_only(gbar[:, idx], tile, kc + tile[1]), payload[:, idx],
                      out_k[:, idx], tile[1], tile[3], normalized)
        ct[:, idx[:kc]] = part[:, :kc]
        ct[:, idx[kc:]] += part[:, kc:]
    return ct


def gat_bwd_dst_tiled(launch: Callable, gbar: torch.Tensor, payload: torch.Tensor,
                      out_k: torch.Tensor, h: int, ch: int, normalized: bool,
                      ct: Optional[torch.Tensor] = None, max_width: int = MAX_WIDTH,
                      dst_row0: int = 0):
    """The destination sweep in launches of at most `max_width` columns;
    launch(gbar, payload, out_k, h, ch, normalized, ct) runs one and
    returns (ct, g2) (the grid's own rows are payload rows dst_row0 ...). A
    head's column tiles add their d a_dst in tile order; G2 takes S_bar
    from the head's first tile."""
    tiles = width_tiles(h, ch, max_width)
    if len(tiles) == 1:
        return launch(gbar, payload, out_k, h, ch, normalized, ct)
    _check_width(h, ch, gbar=gbar, payload=payload, out_k=out_k)
    ct = torch.zeros_like(payload) if ct is None else ct
    gbar, normalized = _raw_gauge(tiles, gbar, payload, out_k, h, ch, normalized,
                                  dst_row0)
    hc = h * ch
    own = slice(dst_row0, dst_row0 + gbar.shape[0])
    dadst = payload.new_zeros((payload.shape[0], h))
    g2 = payload.new_zeros((gbar.shape[0], g2_width(h, ch)))
    for tile in tiles:
        k0, k, _, c = tile
        idx = _tile_index(h, ch, tile, 2, payload.device)
        part, g2_t = launch(_first_tile_only(gbar[:, idx], tile, k * c + k),
                            payload[:, idx], out_k[:, idx], k, c, normalized, None)
        dadst[:, k0: k0 + k] += part[:, k * c + k:]
        idx2 = _tile_index(h, ch, tile, 3, payload.device)
        g2[:, idx2[: k * c]] = g2_t[:, : k * c]
        g2[:, idx2[k * c: k * c + k]] += g2_t[:, k * c: k * c + k]
        g2[:, idx2[k * c + k:]] = g2_t[:, k * c + k:]
    ct[own, hc + h:] = dadst[own]
    return ct, g2


def gat_bwd_src_tiled(launch: Callable, payload: torch.Tensor, g2: torch.Tensor,
                      h: int, ch: int, ct: Optional[torch.Tensor] = None,
                      max_width: int = MAX_WIDTH) -> torch.Tensor:
    """The source sweep in launches of at most `max_width` columns;
    launch(payload, g2, h, ch, ct) runs one. A head's column tiles see its
    S_bar in the first tile only and add their d a_src in tile order."""
    tiles = width_tiles(h, ch, max_width)
    if len(tiles) == 1:
        return launch(payload, g2, h, ch, ct)
    _check_width(h, ch, payload=payload, g2=g2)
    ct = torch.zeros_like(payload) if ct is None else ct
    hc = h * ch
    dasrc = payload.new_zeros((payload.shape[0], h))
    for tile in tiles:
        k0, k, _, c = tile
        idx = _tile_index(h, ch, tile, 2, payload.device)
        idx2 = _tile_index(h, ch, tile, 3, payload.device)
        part = launch(payload[:, idx], _first_tile_only(g2[:, idx2], tile, k * c),
                      k, c, None)
        ct[:, idx[: k * c]] = part[:, : k * c]
        dasrc[:, k0: k0 + k] += part[:, k * c: k * c + k]
    ct[:, hc: hc + h] = dasrc
    return ct


# ---------------- plain PyTorch versions ----------------

def _split(t: torch.Tensor, h: int, ch: int):
    """Packed rows -> ([N, h, ch], [N, h], [N, h])."""
    hc = h * ch
    return t[:, :hc].reshape(-1, h, ch), t[:, hc: hc + h], t[:, hc + h: hc + 2 * h]


def _own_rows(t: torch.Tensor, row0: int, n: int) -> torch.Tensor:
    """Rows row0 .. row0 + n - 1 of t: the grid's own rows of a payload."""
    if row0 < 0 or row0 + n > t.shape[0]:
        raise ValueError(f"the grid's {n} rows from row {row0} do not fit {t.shape[0]} rows")
    return t[row0: row0 + n]


def gat_fwd_plain(g: BsdaGraph, payload: torch.Tensor, h: int, ch: int,
                  negative_slope: float = 0.2, normalize: bool = False,
                  dst_row0: int = 0) -> torch.Tensor:
    """Plain version of the forward kernel: the dense part of
    kernels/bsda_gat.py per head, packed as the kernel packs it; with
    `dst_row0` its rectangular form (g's chunks a run of destination
    chunks, their rows payload rows dst_row0 ..., [grid rows, W] out)."""
    xp, asrc, _ = _split(payload, h, ch)
    adst = _split(_own_rows(payload, dst_row0, _grid_rows(g)), h, ch)[2]
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
                  normalized: bool, dst_row0: int = 0) -> torch.Tensor:
    """Plain version of the backward kernel: the closed form of
    kernels/gat_bwd.py per head, in the kernel's packed interface (with
    `dst_row0` its rectangular form: the payload's cotangent over the
    payload's rows)."""
    xp, asrc, _ = _split(payload, h, ch)
    adst = _split(_own_rows(payload, dst_row0, _grid_rows(g)), h, ch)[2]
    abar, _, sbar = _split(gbar, h, ch)
    val, m, s = _split(out_k, h, ch)
    if normalized:
        inv_s = 1.0 / s.clamp_min(1e-16)
        sbar = sbar - (abar * val).sum(dim=-1) * inv_s
        abar = abar * inv_s[..., None]
    outs = [dense_bwd_head(g, xp[:, k, :], asrc[:, k], adst[:, k], m[:, k],
                           abar[:, k, :], sbar[:, k], negative_slope)
            for k in range(h)]
    ct = torch.zeros_like(payload)
    ct[:, : h * ch] = torch.stack([o[0] for o in outs], dim=1).reshape(-1, h * ch)
    ct[:, h * ch: h * ch + h] = torch.stack([o[1] for o in outs], dim=1)
    _own_rows(ct, dst_row0, _grid_rows(g))[:, h * ch + h:] = torch.stack(
        [o[2] for o in outs], dim=1)
    return ct


def _split_g2(g2: torch.Tensor, h: int, ch: int):
    """G2 rows -> (A_bar [N, h, ch], S_bar, a_dst, m [N, h])."""
    hc = h * ch
    return (g2[:, :hc].reshape(-1, h, ch), g2[:, hc: hc + h],
            g2[:, hc + h: hc + 2 * h], g2[:, hc + 2 * h: hc + 3 * h])


def gat_bwd_dst_plain(g: BsdaGraph, g2: torch.Tensor, payload: torch.Tensor,
                      h: int, ch: int, negative_slope: float,
                      dst_row0: int = 0) -> torch.Tensor:
    """Plain version of the destination sweep: kernels/gat_bwd.py's
    sweep_dst_head per head over the forward tables; the payload's shape
    with the d a_dst columns of the grid's rows (payload rows dst_row0 ...)
    filled and zeros elsewhere."""
    xp, asrc, _ = _split(payload, h, ch)
    abar, sbar, adst, m = _split_g2(g2, h, ch)
    ct = torch.zeros_like(payload)
    _own_rows(ct, dst_row0, _grid_rows(g))[:, h * ch + h:] = torch.stack(
        [sweep_dst_head(g, xp[:, k, :], asrc[:, k], abar[:, k, :], sbar[:, k],
                        adst[:, k], m[:, k], negative_slope) for k in range(h)], dim=1)
    return ct


def gat_bwd_dst_fused_plain(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
                            out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
                            normalized: bool, dst_row0: int = 0):
    """Plain version of the destination-sweep kernel, grad payload
    included: (gat_bwd_dst_plain over grad_payload's G2, that G2 of the
    grid's rows)."""
    g2 = grad_payload(gbar, _own_rows(payload, dst_row0, _grid_rows(g)), out_k, h, ch,
                      normalized)
    return gat_bwd_dst_plain(g, g2, payload, h, ch, negative_slope, dst_row0), g2


def gat_bwd_src_plain(g_t: BsdaGraph, payload: torch.Tensor, g2: torch.Tensor,
                      h: int, ch: int, negative_slope: float,
                      dst_row0: int = 0) -> torch.Tensor:
    """Plain version of the source sweep: kernels/gat_bwd.py's
    sweep_src_head per head over the transpose tables; the payload's shape
    with the d xp and d a_src columns of the own rows (payload rows
    dst_row0 ..., g_t's grid) filled and zeros elsewhere. g2 holds every
    row g_t's ids index."""
    xp, asrc, _ = _split(_own_rows(payload, dst_row0, _grid_rows(g_t)), h, ch)
    abar, sbar, adst, m = _split_g2(g2, h, ch)
    outs = [sweep_src_head(g_t, xp[:, k, :], asrc[:, k], abar[:, k, :], sbar[:, k],
                           adst[:, k], m[:, k], negative_slope) for k in range(h)]
    ct = torch.zeros_like(payload)
    own = _own_rows(ct, dst_row0, _grid_rows(g_t))
    own[:, : h * ch] = torch.stack([o[0] for o in outs], dim=1).reshape(-1, h * ch)
    own[:, h * ch: h * ch + h] = torch.stack([o[1] for o in outs], dim=1)
    return ct


# ---------------- dispatch ----------------

def gat_fwd(g: BsdaGraph, payload: torch.Tensor, h: int, ch: int,
            negative_slope: float = 0.2, normalize: bool = False,
            dst_row0: int = 0) -> torch.Tensor:
    """The kernel for a CUDA payload, the plain version for a CPU one."""
    if payload.is_cuda:
        return gat_fwd_cuda(g, payload, h, ch, negative_slope, normalize,
                            dst_row0=dst_row0)
    return gat_fwd_plain(g, payload, h, ch, negative_slope, normalize, dst_row0)


def gat_bwd(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
            out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
            normalized: bool, dst_row0: int = 0) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if payload.is_cuda:
        return gat_bwd_cuda(g, gbar, payload, out_k, h, ch, negative_slope,
                            normalized, dst_row0)
    return gat_bwd_plain(g, gbar, payload, out_k, h, ch, negative_slope,
                         normalized, dst_row0)


def gat_bwd_dst(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
                out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
                normalized: bool, ct: torch.Tensor, dst_row0: int = 0):
    """The destination sweep into `ct` (gat_bwd_dst_cuda's contract): the
    kernel for CUDA tensors, the plain version for CPU ones. -> (ct, g2)"""
    if payload.is_cuda:
        return gat_bwd_dst_cuda(g, gbar, payload, out_k, h, ch, negative_slope,
                                normalized, ct, dst_row0)
    part, g2 = gat_bwd_dst_fused_plain(g, gbar, payload, out_k, h, ch, negative_slope,
                                       normalized, dst_row0)
    own = slice(dst_row0, dst_row0 + _grid_rows(g))
    ct[own, h * ch + h:] = part[own, h * ch + h:]
    return ct, g2


def gat_bwd_src(g_t: BsdaGraph, payload: torch.Tensor, g2: torch.Tensor, h: int,
                ch: int, negative_slope: float, ct: torch.Tensor,
                dst_row0: int = 0) -> torch.Tensor:
    """The source sweep into `ct` (gat_bwd_src_cuda's contract): the kernel
    for CUDA tensors, the plain version for CPU ones."""
    if payload.is_cuda:
        return gat_bwd_src_cuda(g_t, payload, g2, h, ch, negative_slope, ct, dst_row0)
    part = gat_bwd_src_plain(g_t, payload, g2, h, ch, negative_slope, dst_row0)
    own = slice(dst_row0, dst_row0 + _grid_rows(g_t))
    ct[own, : h * ch + h] = part[own, : h * ch + h]
    return ct


def gat_bwd_two_sweep(g: BsdaGraph, gbar: torch.Tensor, payload: torch.Tensor,
                      out_k: torch.Tensor, h: int, ch: int, negative_slope: float,
                      normalized: bool, dst_row0: int = 0,
                      g_t: Optional[BsdaGraph] = None, t_row0: int = 0,
                      g2_rows: Optional[Callable] = None) -> torch.Tensor:
    """The same cotangent as gat_bwd, bit-reproducible: the destination
    sweep over g, which writes G2, then the source sweep over the transpose
    tables `g_t` (None: g.transpose), each writing its own columns. The
    kernels for CUDA tensors, the plain versions (grad_payload and the two
    sweeps) for CPU ones; without transpose tables it raises.

    The rectangular form: g's own rows are payload rows dst_row0 ..., g_t's
    (its destination chunks are sources of g's edges) payload rows
    t_row0 ..., and `g2_rows` turns the destination sweep's G2 rows into
    the rows g_t's ids index (None: they are those rows). Rows of the
    payload that neither grid owns get a zero cotangent."""
    g_t = g.transpose if g_t is None else g_t
    if g_t is None:
        raise ValueError(
            "the two-sweep GAT backward needs the transpose tables: build the "
            "graph with build_bsda_for_kind(..., 'gat', transpose=True)")
    rows = payload.shape[0]
    whole = dst_row0 == t_row0 == 0 and _grid_rows(g) == _grid_rows(g_t) == rows
    # the sweeps write every column of every row, or of their own rows only
    ct = torch.empty_like(payload) if whole else torch.zeros_like(payload)
    ct, g2 = gat_bwd_dst(g, gbar, payload, out_k, h, ch, negative_slope, normalized,
                         ct, dst_row0)
    if g2_rows is not None:
        g2 = g2_rows(g2)
    return gat_bwd_src(g_t, payload, g2, h, ch, negative_slope, ct, t_row0)
