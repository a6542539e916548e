"""Explicit-collective multi-device aggregation: the halo path (port of
elliptic_gnn_tpu/parallel/shardmap_step.py).

  - The BSDA chunk tables are split per rank: each rank owns a contiguous
    range of destination chunks. With the BFS-clustered ordering every
    source chunk lies within `max_chunk_dist` = H chunks of its destination
    (kernels/bsda.py), so the only remote rows a rank needs are the H
    boundary chunks of its two ring neighbours.
  - The halo exchange is a ring of point-to-point messages
    (`dist.batch_isend_irecv`): the tail goes to rank+1, the head to
    rank-1, 2*H*C rows each way.
  - The exchange overlaps the bulk of the local aggregation: at partition
    time each shard's table is split into a LOCAL part (every block whose
    source chunk the shard owns, sources re-based to local chunks) and a
    small HALO-FIXUP part (the <= 2H boundary destination chunks' blocks
    with remote sources). The local part runs the BSDA kernel
    (kernels/bsda_spmm_cuda.py, csrc/bsda_spmm.cu) on the local rows while
    the messages fly; the fix-up and the residual spill read the
    halo-extended rows [halo_L | local | halo_R] once they have landed.
  - The backward runs the same kernel on the exact block transpose of the
    shard's table over the halo-extended grid, and sends the halo rows'
    cotangents back the reverse way round the ring.
  - GAT (sharded_gat_attend_packed, the model's route): the shard's packed
    payload rows [xp | a_src | a_dst] are ring-exchanged whole, and the
    GAT kernels (kernels/packed_gat.py) run the shard's table at once over
    the halo-extended rows: the rectangular launch, whose destinations are
    the local rows in the middle of the buffer, then the shard's spill.
    The one-sweep backward's cotangent covers the halo rows too; the
    two-sweep backward's source sweep runs on the same block transpose over
    the halo-extended grid (the `use_kernel` tables). The halo rows'
    cotangents go back round the ring. sharded_gat_attend, the plain
    chunk-pair attention, stays as the CPU yardstick.

The training step that uses this (BatchNorm statistics and the loss
all-reduced, one all-reduce of the flat gradient buffer) is in
train/train_gnn.py; the rank and the group travel with the shard
(`ShardedBsda.rank`, `.group`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.bsda import BsdaGraph, bsda_dense_plain, pack_a_planes
from ..kernels.ell import EllGraph
from ..kernels.encoding import GraphEncoding

# the BSDA kernel's group of destination chunks (kernels/bsda_spmm_cuda.py
# _GROUP; the TPU kernel's pallas_bsda.GROUP): the transpose grid is padded
# to a multiple of max(GROUP, H) chunks, as the JAX package pads it
GROUP = 8
NEG_INF = -1e30

_TENSOR_FIELDS = ("a", "src_local", "res_rows", "res_perm", "dst_scale",
                  "src_scale_ext", "rest_rows", "rest_perm", "a_loc", "src_loc",
                  "hal_a", "hal_src", "hal_dst", "a_t", "src_t", "ds_kern",
                  "ss_kern", "a_loc_p", "a_t_p", "a_p", "src_ext", "occ", "occ_t")
_TUPLE_FIELDS = ("res_nbr", "res_w", "res_dst", "rest_nbr", "rest_w", "res_cix")


@dataclasses.dataclass
class ShardedBsda(GraphEncoding):
    """BSDA shards stacked over a leading rank axis, the JAX package's
    ShardedBsda field for field (torch tensors, `use_pallas` named
    `use_kernel`; no `axis_name`: the process group travels instead).
    `shard_slice` cuts one rank's tables out of the stack.

    a:          [n_dev, B_loc, D, C, C]
    src_local:  [n_dev, B_loc, D] EXT-LOCAL source-chunk ids, into the
                halo-extended rows [halo_L | local | halo_R] of B_loc + 2H
                chunks
    res_nbr, res_w, res_dst: tuples over pow2-width buckets of the residual
                spill, [n_dev, R_k, W_k] ext-local source rows, their true
                edge weights (0 = padding) and [n_dev, R_k] the local
                destination row of each bucket row (pad: n_loc)
    res_perm:   [n_dev, R_u] position in the concatenated bucket outputs of
                the t-th sorted destination row
    res_rows:   [n_dev, R_u] unique local destination rows, ascending; pads
                hold distinct out-of-range values n_loc + t
    rest_*:     the same edges grouped by ext source row (the spill's
                backward; rest_nbr holds local destination rows, rest_rows
                unique ext sources, pads n_ext + t)
    dst_scale:  [n_dev, N_loc] f32 or None: factored row scales
    src_scale_ext: [n_dev, N_ext] f32 or None: column scales over the ext rows
    a_loc, src_loc: the LOCAL split (halo-source blocks zeroed, sources in
                local chunks, zeroed slots self-pointing)
    hal_a [n_dev, K_h, D_h, C, C] f32, hal_src [n_dev, K_h, D_h] ext source
                chunks, hal_dst [n_dev, K_h] local destination chunks
                ascending (pads B_loc + t): the halo fix-up
    a_t, src_t [n_dev, b_ext_pad, DT(, C, C)]: the exact block transpose
                over the ext grid padded to the kernel's group (use_kernel)
    ds_kern, ss_kern [n_dev, b_ext_pad*C]: dst scales at ext offset, src
                scales over ext rows (the transpose's src and dst scales)
    a_loc_p, a_t_p: bit-packed planes of a_loc and a_t (a_pack > 1)
    The GAT kernels' tables (the port's own; the whole shard table at once
    over the ext rows): a_p [n_dev, B_loc, planes, C, C] the bit-packed
    planes of `a` and a_p_pack its slots a byte (None and 1 where g has
    none), src_ext [n_dev, B_loc, D] int32 src_local, occ [n_dev, B_loc]
    the slot cover of `a` (g's slot_occ), occ_t [n_dev, b_ext_pad] the
    filled slots of a_t (use_kernel).
    res_cix:    tuple of [1, R_k] (a slice only): each spill bucket row's
                place among res_rows, so that the spill reads as an ELL
                residual (_gat_view)

    A slice of one rank (`shard_slice`) has a leading axis of length 1,
    the pads that the JAX package's scatters drop cut off, int64 index
    tables (the kernel's src_loc/src_t/src_ext stay int32), and carries
    `rank` and the process `group` (None: the world).
    """

    a: torch.Tensor
    src_local: torch.Tensor
    res_nbr: tuple
    res_w: tuple
    res_dst: tuple
    res_rows: torch.Tensor
    res_perm: torch.Tensor
    dst_scale: Optional[torch.Tensor]
    src_scale_ext: Optional[torch.Tensor]
    chunk: int
    depth: int
    num_chunks_global: int
    halo_chunks: int
    n_dev: int
    rest_nbr: tuple = ()
    rest_w: tuple = ()
    rest_rows: Optional[torch.Tensor] = None
    rest_perm: Optional[torch.Tensor] = None
    a_loc: Optional[torch.Tensor] = None
    src_loc: Optional[torch.Tensor] = None
    hal_a: Optional[torch.Tensor] = None
    hal_src: Optional[torch.Tensor] = None
    hal_dst: Optional[torch.Tensor] = None
    a_t: Optional[torch.Tensor] = None
    src_t: Optional[torch.Tensor] = None
    ds_kern: Optional[torch.Tensor] = None
    ss_kern: Optional[torch.Tensor] = None
    use_kernel: bool = False
    b_ext_pad: int = 0
    depth_t: int = 0
    a_dtype_name: str = "float32"
    a_loc_p: Optional[torch.Tensor] = None
    a_t_p: Optional[torch.Tensor] = None
    a_pack: int = 1
    a_p: Optional[torch.Tensor] = None
    a_p_pack: int = 1
    src_ext: Optional[torch.Tensor] = None
    occ: Optional[torch.Tensor] = None
    occ_t: Optional[torch.Tensor] = None
    res_cix: tuple = ()
    rank: Optional[int] = None
    group: Optional[dist.ProcessGroup] = None

    def _map(self, fn) -> "ShardedBsda":
        kw = {k: None if getattr(self, k) is None else fn(getattr(self, k))
              for k in _TENSOR_FIELDS}
        kw.update({k: tuple(fn(t) for t in getattr(self, k)) for k in _TUPLE_FIELDS})
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "ShardedBsda":
        """A copy with every table on `device`."""
        return self._map(lambda t: t.to(device))

    def spmm(self, x, compute_dtype=None):
        return sharded_bsda_spmm(self, x, compute_dtype=compute_dtype)

    def gat_attend(self, x_proj, alpha_src, alpha_dst, negative_slope=0.2):
        return sharded_gat_attend(self, x_proj, alpha_src, alpha_dst, negative_slope)

    def packed_gat_route(self):
        """This rank's shard (sharded_gat_attend_packed), on either device."""
        return (self.a.shape[1] * self.chunk,
                lambda p, h, ch, s: sharded_gat_attend_packed(self, p, h, ch, s))


def _bucket_group(n_dev: int, dev_of: np.ndarray, keys: np.ndarray,
                  gath: np.ndarray, w: np.ndarray, pad_base: int):
    """Group per-device edge lists by `keys` (the row each edge's output
    lands on, already device-local) into pow2-width-bucketed tables.

    Returns (nbr tuple of [n_dev, R_k, W_k] int32 gathered ids, w tuple of
    [n_dev, R_k, W_k] f32 (0 = padding), dst tuple of [n_dev, R_k] int32 key
    row per bucket row (pad -> pad_base), rows [n_dev, R_u] int32 unique
    keys ascending with distinct pads pad_base + t, perm [n_dev, R_u] int32
    concat position of the t-th sorted row). Within a row the edges keep
    their input order."""
    per_dev = []
    for d in range(n_dev):
        sel = dev_of == d
        rows_u, inv = np.unique(keys[sel], return_inverse=True)
        counts = (np.bincount(inv, minlength=rows_u.size)
                  if rows_u.size else np.zeros(0, np.int64))
        per_dev.append((sel, rows_u, inv, counts))

    width_set = {
        int(2 ** np.ceil(np.log2(max(int(cnt), 1))))
        for _, _, _, counts in per_dev for cnt in counts
    }
    widths = sorted(width_set) or [1]
    n_buckets = len(widths)
    b_idx_dev = []
    r_k_max = [1] * n_buckets
    r_u_max = 1
    for _, rows_u, _, counts in per_dev:
        b_idx = np.searchsorted(widths, np.maximum(counts, 1), side="left")
        b_idx_dev.append(b_idx)
        for k in range(n_buckets):
            r_k_max[k] = max(r_k_max[k], int((b_idx == k).sum()))
        r_u_max = max(r_u_max, rows_u.size)

    offsets = np.concatenate([[0], np.cumsum(r_k_max)])
    out_nbr = [np.zeros((n_dev, r_k_max[k], widths[k]), np.int32)
               for k in range(n_buckets)]
    out_w = [np.zeros((n_dev, r_k_max[k], widths[k]), np.float32)
             for k in range(n_buckets)]
    out_dst = [np.full((n_dev, r_k_max[k]), pad_base, np.int32)
               for k in range(n_buckets)]
    out_rows = np.tile(np.arange(r_u_max, dtype=np.int32)[None, :], (n_dev, 1)) + pad_base
    out_perm = np.zeros((n_dev, r_u_max), np.int32)
    for d, (sel, rows_u, inv, counts) in enumerate(per_dev):
        if not rows_u.size:
            continue
        g_d, w_d, b_idx = gath[sel], w[sel], b_idx_dev[d]
        pos_in_bucket = np.zeros(rows_u.size, np.int64)
        for k in range(n_buckets):
            in_k = np.nonzero(b_idx == k)[0]
            pos_in_bucket[in_k] = np.arange(in_k.size)
        # each edge's slot within its row, in input order
        order = np.argsort(inv, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.empty(inv.size, np.int64)
        slot[order] = np.arange(inv.size) - np.repeat(starts, counts)
        for k in range(n_buckets):
            e = b_idx[inv] == k
            out_nbr[k][d, pos_in_bucket[inv[e]], slot[e]] = g_d[e]
            out_w[k][d, pos_in_bucket[inv[e]], slot[e]] = w_d[e]
            in_k = b_idx == k
            out_dst[k][d, pos_in_bucket[in_k]] = rows_u[in_k]
        out_perm[d, : rows_u.size] = offsets[b_idx] + pos_in_bucket
        out_rows[d, : rows_u.size] = rows_u.astype(np.int32)
    as_t = torch.from_numpy
    return (tuple(as_t(t) for t in out_nbr), tuple(as_t(t) for t in out_w),
            tuple(as_t(t) for t in out_dst), as_t(out_rows), as_t(out_perm))


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def partition_bsda(g: BsdaGraph, n_dev: int,
                   use_kernel: Optional[bool] = None) -> ShardedBsda:
    """Split a BsdaGraph (on any device) into n_dev contiguous
    destination-chunk ranges with boundary-only halos; the tables come back
    on the CPU, stacked over ranks, equal to the JAX package's.

    Requires num_chunks % n_dev == 0 (pad_bsda_chunks) and a banded
    ordering: every source chunk and residual source within
    max_chunk_dist <= B_loc of its destination's range. Raises ValueError
    for graphs that are not banded enough.

    use_kernel: build the block transpose and its scales (the backward of
    an aggregation: sage/gcn, and the GAT two-sweep backward's source
    sweep) and the bit-packed planes. The GAT kernels' forward tables
    (a_p, src_ext, occ) are cut from g's always. None = auto, on where
    CUDA is available."""
    b = g.num_chunks
    if b % n_dev:
        raise ValueError(f"num_chunks {b} does not tile {n_dev} devices")
    b_loc = b // n_dev
    c = g.chunk
    h = max(1, int(g.max_chunk_dist))
    if h > b_loc:
        raise ValueError(
            f"halo {h} chunks exceeds per-device range {b_loc}; graph is "
            "not banded enough for boundary-only exchange (GSPMD path "
            "handles this case)"
        )

    a = _np(g.a).reshape(n_dev, b_loc, g.depth, c, c)
    src_g = _np(g.src_chunk).astype(np.int64).reshape(n_dev, b_loc, g.depth)
    dev_start = (np.arange(n_dev) * b_loc)[:, None, None]
    src_local = src_g - dev_start + h
    if src_local.min() < 0 or src_local.max() >= b_loc + 2 * h:
        raise ValueError("source chunk outside halo window; not banded")
    comm_frac = 2 * h / b
    print(f"[SHARDMAP] halo {h} chunks/side per device; boundary exchange "
          f"moves {2*h*c} rows/chip vs {b*c} full gather "
          f"({comm_frac:.2%} of all-gather volume)")

    # the residual ELL (compact rows) flattened back to per-edge lists
    nbr_all, w_all, dst_all = [], [], []
    if g.residual is not None:
        rows_nodes = _np(g.residual_rows)
        for nbr, w, rows, scale in zip(g.residual.nbrs, g.residual.weights,
                                       g.residual.rows, g.residual.row_scale):
            nbr, w = _np(nbr), _np(w) * _np(scale)[:, None]
            rr = rows_nodes[_np(rows)]
            r_idx, s_idx = np.where(w != 0)
            nbr_all.append(nbr[r_idx, s_idx])
            w_all.append(w[r_idx, s_idx])
            dst_all.append(rr[r_idx])
    e_nbr = np.concatenate(nbr_all).astype(np.int64) if nbr_all else np.zeros(0, np.int64)
    e_w = np.concatenate(w_all) if w_all else np.zeros(0, np.float32)
    e_dst = np.concatenate(dst_all).astype(np.int64) if dst_all else np.zeros(0, np.int64)

    n_loc = b_loc * c
    n_ext = (b_loc + 2 * h) * c
    dev_of = e_dst // n_loc
    # residual sources must live inside the destination's halo window too
    nbr_ext_all = e_nbr - dev_of * n_loc + h * c
    if e_nbr.size and (nbr_ext_all.min() < 0 or nbr_ext_all.max() >= n_ext):
        raise ValueError("residual source outside halo window; not banded")

    # per device: the spill in pow2-width buckets and a merge permutation,
    # applied with one scatter onto unique sorted rows; and the same edges
    # grouped by ext source row, for the spill's backward
    res_nbr, res_w, res_dst, res_rows, res_perm = _bucket_group(
        n_dev, dev_of, e_dst - dev_of * n_loc, nbr_ext_all, e_w, pad_base=n_loc)
    rest_nbr, rest_w, _, rest_rows, rest_perm = _bucket_group(
        n_dev, dev_of, nbr_ext_all, e_dst - dev_of * n_loc, e_w, pad_base=n_ext)

    def split_scale(s, ext: bool):
        if s is None:
            return None
        s = _np(s)  # [b*c] padded at build
        if not ext:
            return s.reshape(n_dev, n_loc)
        out = np.zeros((n_dev, n_ext), np.float32)
        for d in range(n_dev):
            lo, hi = d * n_loc - h * c, (d + 1) * n_loc + h * c
            src_lo, src_hi = max(lo, 0), min(hi, s.size)
            out[d, src_lo - lo: src_hi - lo] = s[src_lo:src_hi]
        return out

    if use_kernel is None:
        use_kernel = torch.cuda.is_available()

    # the LOCAL/HALO split: blocks whose source chunk the shard owns go to
    # a_loc with sources in local chunks (zeroed slots self-point); the
    # boundary destination chunks' remote-source blocks go to the fix-up
    nonzero = a.any(axis=(3, 4))  # [n_dev, b_loc, D]
    mask_halo = (src_local < h) | (src_local >= h + b_loc)
    l_idx = np.arange(b_loc)[None, :, None]
    a_loc_np = np.where(mask_halo[..., None, None], 0, a).astype(a.dtype)
    src_loc_np = np.where(mask_halo, l_idx, src_local - h).astype(np.int32)

    fix_mask = mask_halo & nonzero
    per_dev_fix = []
    k_h = d_h = 1
    for dev in range(n_dev):
        ls, dis = np.nonzero(fix_mask[dev])
        chunks_u, inv = np.unique(ls, return_inverse=True)
        slots = [[] for _ in range(chunks_u.size)]
        for pos, (l_i, d_i) in enumerate(zip(ls, dis)):
            slots[inv[pos]].append((l_i, d_i))
        per_dev_fix.append((chunks_u, slots))
        k_h = max(k_h, chunks_u.size)
        d_h = max(d_h, max((len(s) for s in slots), default=1))
    hal_dst_np = np.tile(np.arange(k_h, dtype=np.int32)[None, :], (n_dev, 1)) + b_loc
    hal_a_np = np.zeros((n_dev, k_h, d_h, c, c), np.float32)
    hal_src_np = np.zeros((n_dev, k_h, d_h), np.int32)
    for dev, (chunks_u, slots) in enumerate(per_dev_fix):
        hal_dst_np[dev, : chunks_u.size] = chunks_u.astype(np.int32)
        for ki, sl in enumerate(slots):
            for si, (l_i, d_i) in enumerate(sl):
                hal_a_np[dev, ki, si] = a[dev, l_i, d_i].astype(np.float32)
                hal_src_np[dev, ki, si] = int(src_local[dev, l_i, d_i])

    a_t = src_t = ds_kern = ss_kern = a_loc_p = a_t_p = occ_t = None
    b_ext_pad = depth_t = 0
    if use_kernel:
        # the kernel's backward: the same kernel on the exact block
        # transpose over the halo-extended grid: ext chunk j receives
        # a[l, di]^T from every (l, di) with src_local[l, di] == j
        grp = max(GROUP, h)
        b_ext = b_loc + 2 * h
        b_ext_pad = -(-b_ext // grp) * grp
        refs = [[[] for _ in range(b_ext_pad)] for _ in range(n_dev)]
        for dev in range(n_dev):
            ls, dis = np.nonzero(nonzero[dev])
            for l_i, d_i in zip(ls, dis):
                refs[dev][int(src_local[dev, l_i, d_i])].append((l_i, d_i))
        depth_t = max(1, max(len(r) for dev_r in refs for r in dev_r))
        occ_t = np.array([[len(r) for r in dev_r] for dev_r in refs], np.int32)
        a_t_np = np.zeros((n_dev, b_ext_pad, depth_t, c, c), a.dtype)
        src_t_np = np.tile(np.arange(b_ext_pad, dtype=np.int32)[None, :, None],
                           (n_dev, 1, depth_t))
        for dev in range(n_dev):
            for j, r in enumerate(refs[dev]):
                for slot, (l_i, d_i) in enumerate(r):
                    a_t_np[dev, j, slot] = a[dev, l_i, d_i].T
                    src_t_np[dev, j, slot] = l_i + h

        def embed_scale(s, at_ext_offset: bool):
            """[n_dev, b_ext_pad*c] scales of the transpose's view: local
            scales at ext offset h*c, or the ext-range scales zero-padded to
            the group grid."""
            if s is None:
                return None
            out = np.zeros((n_dev, b_ext_pad * c), np.float32)
            if at_ext_offset:
                out[:, h * c: h * c + b_loc * c] = s
            else:
                out[:, : s.shape[1]] = s
            return out

        if g.a_pack > 1:
            a_loc_p = np.stack([pack_a_planes(a_loc_np[dev], g.a_pack)
                                for dev in range(n_dev)])
            a_t_p = np.stack([pack_a_planes(a_t_np[dev], g.a_pack)
                              for dev in range(n_dev)])
        a_t, src_t = a_t_np, src_t_np
        ds_kern = embed_scale(split_scale(g.dst_scale, ext=False), True)
        ss_kern = embed_scale(split_scale(g.src_scale, ext=True), False)

    def t(arr):
        return None if arr is None else torch.from_numpy(np.ascontiguousarray(arr))

    a_p = occ = None
    if g.a_packed is not None and g.a_pack > 1:
        a_p = _np(g.a_packed).reshape((n_dev, b_loc) + tuple(g.a_packed.shape[1:]))
    if g.slot_occ is not None:
        occ = _np(g.slot_occ).reshape(n_dev, b_loc)

    return ShardedBsda(
        a=t(a), src_local=t(src_local.astype(np.int32)),
        res_nbr=res_nbr, res_w=res_w, res_dst=res_dst,
        rest_nbr=rest_nbr, rest_w=rest_w, rest_rows=rest_rows, rest_perm=rest_perm,
        res_rows=res_rows, res_perm=res_perm,
        dst_scale=t(split_scale(g.dst_scale, ext=False)),
        src_scale_ext=t(split_scale(g.src_scale, ext=True)),
        chunk=c, depth=g.depth, num_chunks_global=b, halo_chunks=h, n_dev=n_dev,
        a_loc=t(a_loc_np), src_loc=t(src_loc_np),
        hal_a=t(hal_a_np), hal_src=t(hal_src_np), hal_dst=t(hal_dst_np),
        a_t=t(a_t), src_t=t(src_t), ds_kern=t(ds_kern), ss_kern=t(ss_kern),
        use_kernel=bool(use_kernel), b_ext_pad=b_ext_pad, depth_t=depth_t,
        a_dtype_name=g.a_dtype_name, a_loc_p=t(a_loc_p), a_t_p=t(a_t_p),
        a_pack=g.a_pack if a_loc_p is not None else 1,
        a_p=t(a_p), a_p_pack=g.a_pack if a_p is not None else 1,
        src_ext=t(src_local.astype(np.int32)), occ=t(occ), occ_t=t(occ_t),
    )


def shard_slice(sg: ShardedBsda, d: int,
                group: Optional[dist.ProcessGroup] = None) -> ShardedBsda:
    """Rank d's tables, each its own contiguous tensor with a leading axis
    of length 1 (what shard_map delivers to shard d in the JAX package):
    the rows of the per-rank tables that the JAX scatters drop (pads beyond
    the valid hal_dst, res_rows and rest_rows entries) cut off, the index
    tables in int64 (src_loc and src_t stay int32 for the kernel), and
    res_dst clamped into the shard's rows. Drives one shard's aggregation
    outside a process group too (shard_local_aggregate)."""
    n_loc = sg.a.shape[1] * sg.chunk
    n_ext = n_loc + 2 * sg.halo_chunks * sg.chunk
    b_loc = sg.a.shape[1]
    one = sg._map(lambda t: t[d: d + 1].clone())
    k_hal = int((one.hal_dst[0] < b_loc).sum())
    k_res = int((one.res_rows[0] < n_loc).sum())
    k_rest = int((one.rest_rows[0] < n_ext).sum()) if one.rest_rows is not None else 0
    res_rows = one.res_rows[:, :k_res].long()
    return dataclasses.replace(
        one,
        hal_dst=one.hal_dst[:, :k_hal].long(),
        hal_src=one.hal_src[:, :k_hal].long(),
        hal_a=one.hal_a[:, :k_hal].contiguous(),
        res_rows=res_rows,
        res_cix=tuple(torch.searchsorted(res_rows[0], t[0].long().clamp(0, n_loc - 1))
                      .clamp(max=max(k_res - 1, 0))[None] for t in one.res_dst),
        res_perm=one.res_perm[:, :k_res].long(),
        res_nbr=tuple(t.long() for t in one.res_nbr),
        res_dst=tuple(t.clamp(0, n_loc - 1).long() for t in one.res_dst),
        rest_rows=(None if one.rest_rows is None else one.rest_rows[:, :k_rest].long()),
        rest_perm=(None if one.rest_perm is None else one.rest_perm[:, :k_rest].long()),
        rest_nbr=tuple(t.long() for t in one.rest_nbr),
        src_local=one.src_local.long(),
        rank=d, group=group,
    )


# ---------------- one shard's aggregation ----------------

def _local_view(sg: ShardedBsda) -> BsdaGraph:
    """BsdaGraph view of the LOCAL split tables: the kernel (or its plain
    version) runs on the local rows in local chunk coordinates, with no
    data dependency on the halo exchange."""
    c = sg.chunk
    hc = sg.halo_chunks * c
    b_loc = sg.a.shape[1]
    n_loc = b_loc * c
    return BsdaGraph(
        a=sg.a_loc[0], src_chunk=sg.src_loc[0], residual=None,
        residual_rows=None, num_nodes=n_loc, num_chunks=b_loc,
        depth=sg.depth, n_pad=0, a_dtype_name=sg.a_dtype_name, chunk=c,
        max_chunk_dist=sg.halo_chunks,
        dst_scale=None if sg.dst_scale is None else sg.dst_scale[0],
        src_scale=(None if sg.src_scale_ext is None
                   else sg.src_scale_ext[0, hc: hc + n_loc]),
        a_packed=None if sg.a_loc_p is None else sg.a_loc_p[0],
        a_pack=sg.a_pack if sg.a_loc_p is not None else 1,
    )


def _transpose_view(sg: ShardedBsda) -> BsdaGraph:
    """BsdaGraph view of the block transpose over the ext grid: the
    backward ct_ext = ss * (A^T @ (ds * ct)), so the scales swap roles (the
    view's dst scale is ss over ext rows, its src scale ds at ext offset).
    a_t transposes the whole shard table (local and halo blocks): one launch
    covers the cotangents of both forward terms."""
    c = sg.chunk
    return BsdaGraph(
        a=sg.a_t[0], src_chunk=sg.src_t[0], residual=None, residual_rows=None,
        num_nodes=sg.b_ext_pad * c, num_chunks=sg.b_ext_pad, depth=sg.depth_t,
        n_pad=0, a_dtype_name=sg.a_dtype_name, chunk=c,
        max_chunk_dist=sg.halo_chunks,
        dst_scale=None if sg.ss_kern is None else sg.ss_kern[0],
        src_scale=None if sg.ds_kern is None else sg.ds_kern[0],
        a_packed=None if sg.a_t_p is None else sg.a_t_p[0],
        a_pack=sg.a_pack if sg.a_t_p is not None else 1,
        slot_occ=None if sg.occ_t is None else sg.occ_t[0],
    )


def _gat_view(sg: ShardedBsda) -> BsdaGraph:
    """BsdaGraph view of the shard's whole table for the GAT kernels'
    rectangular launch over the halo-extended rows: its destination chunks
    are the local rows (ext rows H*C ...), src_chunk holds ext chunk ids,
    and the spill reads as an ELL residual (sources ext rows, residual_rows
    the local rows)."""
    c = sg.chunk
    b_loc = sg.a.shape[1]
    residual = residual_rows = None
    if sg.res_rows.shape[1] and len(sg.res_nbr):
        residual_rows = sg.res_rows[0]
        residual = EllGraph(
            nbrs=tuple(t[0] for t in sg.res_nbr), weights=tuple(t[0] for t in sg.res_w),
            rows=tuple(t[0] for t in sg.res_cix), inv_perm=sg.res_perm[0], row_scale=(),
            num_nodes=int(residual_rows.shape[0]),
            widths=tuple(int(t.shape[2]) for t in sg.res_nbr), n_zero_deg=0)
    return BsdaGraph(
        a=sg.a[0], src_chunk=sg.src_ext[0], residual=residual,
        residual_rows=residual_rows, num_nodes=b_loc * c, num_chunks=b_loc,
        depth=sg.depth, n_pad=0, a_dtype_name=sg.a_dtype_name, chunk=c,
        max_chunk_dist=sg.halo_chunks,
        a_packed=None if sg.a_p is None else sg.a_p[0], a_pack=sg.a_p_pack,
        slot_occ=None if sg.occ is None else sg.occ[0],
    )


def _halo_fixup(sg: ShardedBsda, xe: torch.Tensor) -> torch.Tensor:
    """The boundary destination chunks' halo-source contributions
    [K_h, C, F] f32 (chunk rows sg.hal_dst), read from the halo-extended
    rows: the only dense compute that waits on the exchange."""
    c = sg.chunk
    b_loc = sg.a.shape[1]
    xe3 = xe.reshape(-1, c, xe.shape[-1])
    gath = xe3[sg.hal_src[0]]  # [K_h, D_h, C, F]
    if sg.src_scale_ext is not None:
        ss3 = sg.src_scale_ext[0].reshape(-1, c)
        gath = gath * ss3[sg.hal_src[0]][..., None].to(gath.dtype)
    fix = torch.einsum("kdij,kdjf->kif", sg.hal_a[0].to(gath.dtype).float(),
                       gath.float())
    if sg.dst_scale is not None:
        fix = fix * sg.dst_scale[0].reshape(b_loc, c)[sg.hal_dst[0]][..., None]
    return fix


def _residual_spill(sg: ShardedBsda, xe: torch.Tensor) -> torch.Tensor:
    """Width-bucketed residual partial sums [R_u, F] f32 in sorted
    destination order (rows sg.res_rows); products in xe's dtype, the true
    edge weights rounded to it, as the single-device spill takes them."""
    outs = [torch.einsum("rw,rwf->rf", w_k[0].to(xe.dtype).float(),
                         xe[nbr_k[0]].float())
            for nbr_k, w_k in zip(sg.res_nbr, sg.res_w)]
    return torch.cat(outs, dim=0)[sg.res_perm[0]]


def _apply_ext_terms(sg: ShardedBsda, out: torch.Tensor,
                     xe: torch.Tensor) -> torch.Tensor:
    """The halo fix-up and the residual spill added in place into the local
    dense result, in out's dtype."""
    c = sg.chunk
    b_loc = sg.a.shape[1]
    f = out.shape[-1]
    out.view(b_loc, c, f).index_add_(0, sg.hal_dst[0], _halo_fixup(sg, xe).to(out.dtype))
    return out.index_add_(0, sg.res_rows[0], _residual_spill(sg, xe).to(out.dtype))


class _Pending:
    """The posted messages of one halo exchange; `wait` before the halo
    rows are read."""

    def __init__(self):
        self.works = []

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        self.works = []


def _peers(sg: ShardedBsda):
    left, right = (sg.rank - 1) % sg.n_dev, (sg.rank + 1) % sg.n_dev
    if sg.group is not None:
        left = dist.get_global_rank(sg.group, left)
        right = dist.get_global_rank(sg.group, right)
    return left, right


def _ring(sends, recvs, group, pending: Optional[_Pending]) -> None:
    """Post (tensor, peer, tag) sends, then receives, in this fixed order:
    where both neighbours are one peer (two ranks) the messages match by
    tag (gloo) and by their order (NCCL)."""
    ops = [dist.P2POp(dist.isend, t, p, group, tag) for t, p, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, p, group, tag) for t, p, tag in recvs]
    works = dist.batch_isend_irecv(ops)
    if pending is None:
        for w in works:
            w.wait()
    else:
        pending.works.extend(works)


class _HaloExchange(torch.autograd.Function):
    """(halo_l, halo_r) = (rank-1's last hc rows, rank+1's first hc rows);
    the messages are posted and their completion left in `pending`. The
    backward sends the halo cotangents back the reverse way (the transpose
    of a ring shift is the opposite shift) and adds them onto the rows they
    came from."""

    @staticmethod
    def forward(ctx, x, hc, sg, pending):
        ctx.hc, ctx.sg = hc, sg
        left, right = _peers(sg)
        halo_l = x.new_empty((hc,) + tuple(x.shape[1:]))
        halo_r = x.new_empty((hc,) + tuple(x.shape[1:]))
        _ring(sends=[(x[-hc:].contiguous(), right, 0), (x[:hc].contiguous(), left, 1)],
              recvs=[(halo_l, left, 0), (halo_r, right, 1)],
              group=sg.group, pending=pending)
        return halo_l, halo_r

    @staticmethod
    def backward(ctx, d_l, d_r):
        hc, sg = ctx.hc, ctx.sg
        left, right = _peers(sg)
        d_l = d_l.contiguous()
        d_r = d_r.contiguous()
        d_tail, d_head = torch.empty_like(d_l), torch.empty_like(d_r)
        _ring(sends=[(d_l, left, 2), (d_r, right, 3)],
              recvs=[(d_tail, right, 2), (d_head, left, 3)],
              group=sg.group, pending=None)
        dx = d_l.new_zeros((sg.a.shape[1] * sg.chunk,) + tuple(d_l.shape[1:]))
        dx[-hc:] += d_tail
        dx[:hc] += d_head
        return dx, None, None, None


def halo_exchange(sg: ShardedBsda, x: torch.Tensor, pending: Optional[_Pending] = None):
    """The ring exchange of x's boundary rows: (halo_l, halo_r), landed, or
    with `pending` posted and to be waited for there. With one rank the
    ring is the identity, as a ppermute over one device is: the rank's own
    tail and head, no message."""
    hc = sg.halo_chunks * sg.chunk
    if sg.n_dev == 1:
        return x[-hc:], x[:hc]
    return _HaloExchange.apply(x, hc, sg, pending)


class _KernelSplitAggregate(torch.autograd.Function):
    """One shard's aggregation through the BSDA kernel, under one backward
    rule (port of _pallas_split_aggregate): forward the local split tables
    (independent of the halos: it runs while the exchange flies), then the
    wait, then the fix-up and spill gathers on the halo-extended rows and
    their scatters into the kernel's result; backward the transpose-residual
    tables, the kernel on the block-transpose view, and the one scatter of
    the spill's cotangent into its result. On CPU tensors `dense` is the
    kernel's plain version. The JAX package fences these steps with
    optimization barriers for the TPU compiler; on CUDA the stream runs them
    in the order they were enqueued, which is the same order."""

    @staticmethod
    def forward(ctx, xl, hl, hr, sg, pending):
        from ..kernels.bsda_spmm_cuda import bsda_dense_cuda

        dense = bsda_dense_cuda if xl.is_cuda else bsda_dense_plain
        out = dense(_local_view(sg), xl)
        if pending is not None:
            pending.wait()
        xe = torch.cat([hl, xl, hr], dim=0)
        ctx.sg, ctx.dense = sg, dense
        return _apply_ext_terms(sg, out, xe)

    @staticmethod
    def backward(ctx, ct):
        sg, dense = ctx.sg, ctx.dense
        c, h = sg.chunk, sg.halo_chunks
        hc = h * c
        n_loc = sg.a.shape[1] * c
        f = ct.shape[1]
        ct = ct.contiguous()
        # the spill's cotangent d x_ext[j] = sum_{e: src=j} w_e * ct[dst_e]
        # through the transpose-residual tables (padded slots carry w = 0)
        outs = [torch.einsum("rw,rwf->rf", w_k[0].to(ct.dtype).float(),
                             ct[nbr_k[0]].float())
                for nbr_k, w_k in zip(sg.rest_nbr, sg.rest_w)]
        d_sorted = torch.cat(outs, dim=0)[sg.rest_perm[0]]
        ctp = torch.cat([ct.new_zeros((hc, f)), ct,
                         ct.new_zeros((sg.b_ext_pad * c - hc - n_loc, f))], dim=0)
        d_xe = dense(_transpose_view(sg), ctp)[: n_loc + 2 * hc]
        d_xe.index_add_(0, sg.rest_rows[0], d_sorted.to(d_xe.dtype))
        return d_xe[hc: hc + n_loc], d_xe[:hc], d_xe[hc + n_loc:], None, None


def _split_local_aggregate(sg: ShardedBsda, x_loc: torch.Tensor,
                           halo_l: torch.Tensor, halo_r: torch.Tensor,
                           pending: Optional[_Pending] = None) -> torch.Tensor:
    """One shard's aggregation from its local rows and the two halo halves,
    in x_loc's dtype, through the kernel route (the `use_kernel` tables)."""
    if not sg.use_kernel:
        raise ValueError("these shard tables have no block transpose (partition_bsda "
                         "with use_kernel=False, as GAT builds them): an aggregation "
                         "needs use_kernel=True")
    return _KernelSplitAggregate.apply(x_loc, halo_l, halo_r, sg, pending)


def shard_local_aggregate(sg: ShardedBsda, x_ext: torch.Tensor,
                          out_dtype=None) -> torch.Tensor:
    """One shard's whole aggregation given its halo-extended input rows
    x_ext [(B_loc + 2H) * C, F] (from shard_slice): the local kernel, the
    halo fix-up and the spill, the local rows [B_loc * C, F] out, in
    `out_dtype` (x_ext's by default). Drives each shard's kernel in one
    process with host-assembled halos; the training step exchanges them
    (sharded_bsda_spmm)."""
    hc = sg.halo_chunks * sg.chunk
    n_loc = sg.a.shape[1] * sg.chunk
    out = _split_local_aggregate(sg, x_ext[hc: hc + n_loc], x_ext[:hc],
                                 x_ext[hc + n_loc:])
    return out.to(out_dtype or x_ext.dtype)


def sharded_bsda_spmm(sg: ShardedBsda, x_local: torch.Tensor,
                      compute_dtype=None) -> torch.Tensor:
    """The halo path's aggregation of this rank's rows x_local [N_loc, F]:
    the exchange of the H boundary chunks with both neighbours is posted,
    the local kernel launched on x_local, and the exchange waited for only
    before the fix-up. Returns [N_loc, F] in x_local's dtype, computed in
    `compute_dtype` (bf16 under amp)."""
    out_dtype = x_local.dtype
    xc = x_local.to(compute_dtype) if compute_dtype is not None else x_local
    xc = xc.contiguous()
    pending = _Pending()
    halo_l, halo_r = halo_exchange(sg, xc, pending)
    return _split_local_aggregate(sg, xc, halo_l, halo_r, pending).to(out_dtype)


def sharded_gat_attend_packed(sg: ShardedBsda, payload: torch.Tensor, h: int, ch: int,
                              negative_slope: float = 0.2) -> torch.Tensor:
    """This rank's rows [N_loc, W] of [ val | m | s ] through the GAT
    kernels, from its packed payload rows [N_loc, W] = [xp | a_src | a_dst]
    ('gat' tables): the ring exchange of the boundary rows (a_dst rides
    along; halo rows are never destinations), then the shard's table at
    once over the halo-extended rows [halo_L | local | halo_R] (zero rows
    up to the transpose grid where the block transpose is built), its
    destinations the local rows, and the shard's spill merged.
    Differentiable: the cotangent of the halo rows goes back round the
    ring; the two-sweep backward's source sweep runs the block transpose
    over the ext grid, its G2 rows at their ext offset."""
    from ..kernels.packed_gat import DenseTables, attend_rows

    c = sg.chunk
    hc = sg.halo_chunks * c
    n_loc = sg.a.shape[1] * c
    payload = payload.contiguous()
    halo_l, halo_r = halo_exchange(sg, payload)
    parts = [halo_l, payload, halo_r]
    g_t = g2_rows = None
    if sg.a_t is not None:
        g_t = _transpose_view(sg)
        tail = sg.b_ext_pad * c - n_loc - hc
        parts.append(payload.new_zeros((tail - hc, payload.shape[1])))
        g2_rows = lambda g2: torch.nn.functional.pad(g2, (0, 0, hc, tail))  # noqa: E731
    d = DenseTables(_gat_view(sg), dst_row0=hc, g_t=g_t, g2_rows=g2_rows)
    return attend_rows(d, torch.cat(parts, dim=0), h, ch, negative_slope)


def sharded_gat_attend(sg: ShardedBsda, x_proj: torch.Tensor,
                       alpha_src: torch.Tensor, alpha_dst: torch.Tensor,
                       negative_slope: float = 0.2) -> torch.Tensor:
    """GAT segment-softmax attention of this rank's rows, in plain PyTorch
    (the JAX package runs it in XLA, outside any Pallas kernel): the
    yardstick of sharded_gat_attend_packed, the model's route.

    Every source of a local destination lies within the halo window, so
    the ring exchange of [x_proj | a_src] rows makes the softmax local;
    per shard the dense chunk-pair formulation of kernels/bsda_gat.py runs
    on the halo-extended tables, and the spill's partials merge into it
    with a streaming softmax. Autograd differentiates through it (the
    exchange sends the cotangents back).

    x_proj [N_loc, H, Ch], alpha_src/alpha_dst [N_loc, H]; returns
    [N_loc, H, Ch]. `sg` comes from a 'gat'-kind BsdaGraph (self-looped
    edges, unit multiplicities)."""
    n_loc, h, ch = x_proj.shape
    hch = h * ch
    b_loc = sg.a.shape[1]
    c = sg.chunk

    payload = torch.cat([x_proj.reshape(n_loc, hch).float(), alpha_src.float()], dim=1)
    halo_l, halo_r = halo_exchange(sg, payload.contiguous())
    pay_ext = torch.cat([halo_l, payload, halo_r], dim=0)
    xp_ext = pay_ext[:, :hch].reshape(-1, h, ch)
    asrc_ext = pay_ext[:, hch:]                       # [N_ext, H]
    adst = alpha_dst.float()                          # [N_loc, H]

    mult = sg.a[0].float()                            # [B_loc, D, C, C]
    src = sg.src_local[0]                             # [B_loc, D] ext chunks
    valid = mult > 0
    adst3 = adst.reshape(b_loc, c, h)
    asrc_ext3 = asrc_ext.reshape(-1, c, h)
    xp_ext3 = xp_ext.reshape(-1, c, h, ch)
    neg_inf = asrc_ext.new_full((), NEG_INF)

    ms, ss, accs = [], [], []
    for head in range(h):
        asrc_chunks = asrc_ext3[:, :, head][src]      # [B_loc, D, C]
        scores = torch.where(valid, torch.nn.functional.leaky_relu(
            asrc_chunks[:, :, None, :] + adst3[:, :, head][:, None, :, None],
            negative_slope), neg_inf)
        m_h = scores.amax(dim=(1, 3))                 # [B_loc, C]
        e = torch.exp(scores - m_h[:, None, :, None]) * mult
        xp_h = xp_ext3[:, :, head, :][src]            # [B_loc, D, C, Ch]
        xp_e = torch.cat([xp_h, xp_h.new_ones(xp_h.shape[:-1] + (1,))], dim=-1)
        acc_ext = torch.einsum("bdij,bdjf->bif", e, xp_e)
        ms.append(m_h.reshape(-1))
        ss.append(acc_ext[..., -1].reshape(-1))
        accs.append(acc_ext[..., :-1].reshape(-1, ch))
    m = torch.stack(ms, dim=1)                        # [N_loc, H]
    s = torch.stack(ss, dim=1)
    acc = torch.stack(accs, dim=1)                    # [N_loc, H, Ch]

    rows = sg.res_rows[0]                             # valid unique sorted local
    if rows.numel() and len(sg.res_nbr):
        m2p, s2p, acc2p = [], [], []
        for nbr_k, w_k, dst_k in zip(sg.res_nbr, sg.res_w, sg.res_dst):
            nbr, w, dst = nbr_k[0], w_k[0], dst_k[0]  # [R_k, W_k], pads clamped
            sc = torch.nn.functional.leaky_relu(
                asrc_ext[nbr] + adst[dst][:, None, :], negative_slope)
            sc = torch.where((w > 0)[:, :, None], sc, neg_inf)  # [R_k, W_k, H]
            m_l = sc.amax(dim=1)
            e_l = torch.exp(sc - m_l[:, None, :]) * w[:, :, None]
            m2p.append(m_l)
            s2p.append(e_l.sum(dim=1))
            acc2p.append(torch.einsum("rwh,rwhf->rhf", e_l, xp_ext[nbr]))
        perm = sg.res_perm[0]
        m2, s2 = torch.cat(m2p)[perm], torch.cat(s2p)[perm]
        acc2 = torch.cat(acc2p)[perm]
        cur_m, cur_s, cur_acc = m[rows], s[rows], acc[rows]
        big = torch.maximum(cur_m, m2)
        w1, w2 = torch.exp(cur_m - big), torch.exp(m2 - big)
        s = s.index_copy(0, rows, cur_s * w1 + s2 * w2)
        acc = acc.index_copy(0, rows, cur_acc * w1[..., None] + acc2 * w2[..., None])

    return (acc / torch.clamp(s, min=1e-16)[..., None]).to(x_proj.dtype)
