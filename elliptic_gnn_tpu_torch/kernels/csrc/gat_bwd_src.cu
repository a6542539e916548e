// Flash GAT backward, source sweep, for Hopper (sm_90a): the source-side
// half of the two-sweep vector-Jacobian product of gat_fwd.cu's dense part,
// over the TRANSPOSE tables (kernels/bsda.py::gat_block_transpose),
//
//     e_ij      = mult_ij * exp(lrelu(t_ij) - m_i),  t_ij = a_dst_i + a_src_j
//     d xp_j    = sum_i e_ij * A_i
//     d a_src_j = sum_i e_ij * lrelu'(t_ij) * (xp_j . A_i + S_i)
//
// where (A_i, S_i) are the cotangents of (acc_i, s_i) at fixed m_i, in the
// raw gauge (kernels/gat_bwd.py::grad_payload).
//
// Tables: aT[J, slot, j, i] = a[I, d, i, j] for every nonzero forward block
// (I, d) whose source chunk is J: each plane transposed, rows = sources of
// chunk J, columns = destinations of chunk srcT[J, slot] = I, bit-packed
// like the forward planes; occT[J] slots are filled, the rest are zero
// blocks that point at J itself. They read exactly like forward tables of
// the reversed edges, so bsda_edges.cuh lists them unchanged.
//
// in:  payload the own rows' [ xp | a_src | a_dst ] (the forward's input),
//              of which xp and a_src are read,
//      g2      [n_rows, W2] streamed rows [ A (h*ch) | S (h) | a_dst (h) | m (h) ],
//              W2 = h*ch + 3h: m is the forward's, so e is the forward's.
// out: ct the own rows' d xp and d a_src columns (0 .. h*ch + h); the
//      d a_dst columns belong to gat_bwd_dst.cu.
//
// The rectangular launch (gat_bwd_src_launch_rect): the grid's B chunks are
// a run of source chunks, their rows payload (and ct) rows dst_row0 ...;
// dst_chunk holds chunk ids of g2's n_rows rows. One rank's source rows over
// the all-gathered G2 (GSPMD row sharding). The whole graph is the case
// n_rows = B*128, dst_row0 = 0.
//
// Replaces elliptic_gnn_tpu/kernels/pallas_gat_bwd.py::_sweep_src_call. Not
// carried over: the VMEM ring of G2 chunks, the 128-lane padding, the rank-1
// separable exponent, the transposed [feature, node] layouts and the skinny
// MXU passes over dense 128x128 blocks. Only the edges are walked and e is
// computed per edge.
//
// What bounds it: bytes (the transpose planes, the payload's xp and a_src
// columns and g2 read once, h*ch + h columns written); per edge 3 h ch
// multiply-adds and h exps.
//
// Design (bsda_edges.cuh, as gat_fwd.cu): one block per SOURCE chunk J.
// The block lists the chunk's edges once, each source row's destination
// rows in (slot, i) order (with occT only the covered planes are read),
// then fetches every edge's whole G2 row into shared memory with 16-byte
// cp.async copies (176 bytes at (h, ch) = (4, 8); at (1, 2) the two
// 16-byte blocks that cover its 20 bytes), two buffers deep. A thread group owns a source row and a
// thread CPL runs of V adjacent columns of it (V = 4 where ch is a multiple
// of 4, else 1); the row's xp and a_src are read once at row begin (a
// group's first row while the first batch is in flight), d xp and d a_src
// stay in registers across batches (hub rows need no rescale: m is the
// forward's), and q = xp_j . A_i is summed over the head's runs by xor
// shuffles inside the group where a head's runs are a power of two of lanes
// (else through a scratch row of the group).
//
// Reproducibility: d xp_j and d a_src_j are sums over the edges out of j,
// kept in registers by the one thread group that owns source j and taken
// in list order; the head sums are the same in every launch; each output
// is written once with a plain store. No atomics: two launches on the same
// inputs give the same bits. Any (h, ch) with h*ch + 2h <= 512.
//
// Plain C interface, loaded with ctypes (kernels/gat_cuda.py).

#include <math.h>

#include "bsda_edges.cuh"

namespace {

using namespace bsda;

constexpr int kMaxCols = 512;  // h * ch + 2 h <= 512
// Rows with more edges than this (hub sources: the transpose rows follow
// the out-degrees, up to hundreds at Elliptic scale, where a destination
// row holds about two) are summed by the whole block after the walk, so
// that one thread group does not walk them alone while the others wait.
constexpr int kLongRow = 32;

__device__ __forceinline__ float lrelu(float t, float slope) {
  return t >= 0.f ? t : t * slope;
}

// What the launch fixes for every block.
struct Plan {
  int depth, planes, pack, h, ch;
  float slope;
  int vec;       // the G2 rows' alignment in bytes (16, 8 or 4)
  int list_cap;  // edges a list holds
  int batch;     // edges a gather buffer holds
  int stride;    // bytes between two edges' G2 rows in a buffer
  int group;     // threads that share a row
  int area;      // bytes of the two gather buffers, at least the list's items
  int runs;      // runs of V columns a head holds
  int shuffle;   // head sums by xor shuffles (else a scratch row a group)
  int red;       // bytes of the groups' scratch rows (0 with shuffle)
  int wide;      // rows of payload and ct are 16-byte aligned
  int n_rows;    // g2 rows the gathers may read
  int dst_row0;  // payload (and ct) row of the grid's first row
};

// One source row's sums: the state of a thread, for its CPL runs.
template <int CPL, int V>
struct RowSrcVjp {
  const float* seg;  // this batch's buffer: per edge the G2 row of its destination
  const uint32_t* edge;
  const float* g2;
  int width2;
  const int* edge_off;  // the list's per-row offsets
  const float* payload;
  float* ct;
  float* red;  // the group's scratch row
  size_t row0;  // the chunk's first row in payload and ct
  int stride_f, e0, hc, h, width, runs, n_runs, c, group;
  bool shuffle, wide;
  bool wide2;  // G2 rows are 16-byte aligned; else they are gathered by the
               // 16-byte blocks that cover them, a row word_in_block(its
               // address) words into its slot
  bool skip;  // the row is long: the block sums it after the walk (long_row)
  unsigned mask;
  float slope;
  int col[CPL], head[CPL];
  bool live[CPL], first[CPL];
  float xp[CPL][V], asrc[CPL], dxp[CPL][V], dasrc[CPL];

  template <bool kGlobal>
  static __device__ __forceinline__ float ld(const float* p) {
    if constexpr (kGlobal) return __ldg(p);
    else return *p;
  }

  // V values at p: shared memory, or with kGlobal global memory (`aligned`:
  // 16-byte aligned)
  template <bool kGlobal>
  static __device__ __forceinline__ void ld_run(float (&v)[V], const float* p, bool aligned) {
    if constexpr (V == 1) {
      v[0] = ld<kGlobal>(p);
    } else if (aligned) {
      const float4 x = kGlobal ? __ldg(reinterpret_cast<const float4*>(p))
                               : *reinterpret_cast<const float4*>(p);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = ld<kGlobal>(p + u);
    }
  }

  __device__ __forceinline__ void begin_sums(int row) {
    const float* own = payload + (row0 + row) * width;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      dasrc[k] = 0.f;
#pragma unroll
      for (int u = 0; u < V; ++u) dxp[k][u] = 0.f;
      if (!live[k]) continue;
      asrc[k] = __ldg(own + hc + head[k]);
      ld_run<true>(xp[k], own + col[k], wide);
    }
  }

  // Adds one edge, multiplicity mu, its destination's G2 row at p (shared
  // memory, or global memory with kGlobal).
  template <bool kGlobal>
  __device__ __forceinline__ void add_edge(const float* p, float mu) {
    float ev[CPL], gate[CPL], q[CPL], sbar[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      ev[k] = gate[k] = q[k] = sbar[k] = 0.f;
      if (!live[k]) continue;
      const float t = ld<kGlobal>(p + hc + h + head[k]) + asrc[k];
      // the forward's m makes the exponent <= 0; the clamp matches the
      // plain closed form
      ev[k] = mu * expf(fminf(lrelu(t, slope) - ld<kGlobal>(p + hc + 2 * h + head[k]), 0.f));
      gate[k] = t >= 0.f ? 1.f : slope;
      sbar[k] = ld<kGlobal>(p + hc + head[k]);
      float abar[V];
      // a G2 row is 16-byte aligned in memory and in its slot, or neither
      ld_run<kGlobal>(abar, p + col[k], wide2);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        q[k] += xp[k][u] * abar[u];
        dxp[k][u] += ev[k] * abar[u];
      }
    }
    head_sums<CPL>(q, shuffle, runs, n_runs, c, group, mask, red);
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (live[k]) dasrc[k] += ev[k] * gate[k] * (q[k] + sbar[k]);
  }

  __device__ __forceinline__ void begin(int row) {
    skip = edge_off[row + 1] - edge_off[row] > kLongRow;
    if (!skip) begin_sums(row);
  }

  __device__ __forceinline__ void edges(int lo, int hi) {
    if (skip) return;
    for (int e = lo; e < hi; ++e) {
      const uint32_t w = edge[e];
      const float* p = seg + (size_t)(e - e0) * stride_f;
      if (!wide2) p += word_in_block(g2 + (size_t)(w & kRowMask) * width2);
      add_edge<false>(p, static_cast<float>(w >> 24));
    }
  }

  __device__ __forceinline__ void end(int row) {
    if (skip) return;
    float* o = ct + (row0 + row) * width;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (!live[k]) continue;
      if constexpr (V == 4) {
        if (wide) {
          *reinterpret_cast<float4*>(o + col[k]) =
              make_float4(dxp[k][0], dxp[k][1], dxp[k][2], dxp[k][3]);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) o[col[k] + u] = dxp[k][u];
        }
      } else {
        o[col[k]] = dxp[k][0];
      }
      if (first[k]) o[hc + head[k]] = dasrc[k];
    }
  }

  // A long row (a hub source), after the walk, by every thread of the
  // block: thread group gid takes the row's edges gid, gid + n_groups, ...
  // (`es`, `len` of them) reading the G2 rows from global memory, the
  // groups of a warp add their sums by xor shuffles, and the warps' sums
  // (`part`, kWarps * (hc + h) floats) are added in warp order: the same
  // order, and so the same bits, in every launch. Every thread calls this;
  // it has two block barriers.
  __device__ __forceinline__ void long_row(int row, const uint32_t* es, int len, int gid,
                                           int n_groups, float* part) {
    begin_sums(row);
    for (int k = gid; k < len; k += n_groups)
      add_edge<true>(g2 + (size_t)(es[k] & kRowMask) * width2,
                     static_cast<float>(es[k] >> 24));
    for (int o = group; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        dasrc[k] += __shfl_xor_sync(kFull, dasrc[k], o);
#pragma unroll
        for (int u = 0; u < V; ++u) dxp[k][u] += __shfl_xor_sync(kFull, dxp[k][u], o);
      }
    }
    const int warp = threadIdx.x >> 5;
    const int cols = hc + h;
    __syncthreads();  // the walk is done with the buffers `part` lies in
    if ((threadIdx.x & 31) < group) {  // the warp's first group
      float* w = part + warp * cols;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (!live[k]) continue;
#pragma unroll
        for (int u = 0; u < V; ++u) w[col[k] + u] = dxp[k][u];
        if (first[k]) w[hc + head[k]] = dasrc[k];
      }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < cols; x += kThreads) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += part[w * cols + x];
      ct[(row0 + row) * width + x] = v;
    }
  }
};

template <int CPL, int V, bool kRect>
__global__ void __launch_bounds__(kThreads, (CPL == 1 ? kMinBlocks : 1))
gat_bwd_src_kernel(const uint8_t* __restrict__ a_t,        // [B, planes, C, C]
                   const int32_t* __restrict__ dst_chunk,  // [B, depth]
                   const int32_t* __restrict__ occ,        // [B] or null
                   const float* __restrict__ payload,      // [B*C, W]
                   const float* __restrict__ g2,           // [B*C, W2]
                   float* __restrict__ ct,                 // [B*C, W]
                   const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [2 gather buffers, under them the list's items | the groups' scratch
  // rows | edge list]
  const size_t buf_bytes = (size_t)pl.batch * pl.stride;
  unsigned char* bufs = smem;
  float* red_sm = reinterpret_cast<float*>(smem + pl.area);
  const EdgeList ed = make_list(smem + pl.area + pl.red, smem, pl.list_cap);

  const int b = blockIdx.x;
  // the whole graph's launch (kRect false) takes its rows from the grid:
  // the code it had before the rectangular form, and so its time
  const size_t dst_row0 = kRect ? (size_t)pl.dst_row0 : 0;
  const int hc = pl.h * pl.ch;
  const int width = hc + 2 * pl.h;
  const int width2 = hc + 3 * pl.h;
  // slots at and beyond occ[b] are all zero: their planes are not read
  const int slots = occ != nullptr ? min(occ[b], pl.depth) : pl.depth;
  const int n_planes = (slots + pl.pack - 1) / pl.pack;
  const uint32_t* planes_b = reinterpret_cast<const uint32_t*>(
      a_t + (size_t)b * pl.planes * (size_t)kPlaneBytes);
  const ChunkCounts cc = count_rows(planes_b, n_planes, pl.pack,
                                    dst_chunk + (size_t)b * pl.depth, pl.depth, ed);
  const bool whole = cc.edges <= pl.list_cap;  // the rule: one list for the chunk
  if (!whole) __syncthreads();                 // a hub chunk: the offsets, for group_end

  const int gid = threadIdx.x / pl.group;
  const int c = threadIdx.x % pl.group;
  const int row_step = kThreads / pl.group;
  const int n_rows = kRect ? pl.n_rows : gridDim.x * kChunk;

  RowSrcVjp<CPL, V> op;
  op.edge = ed.edge;
  op.edge_off = ed.edge_off;
  op.g2 = g2;
  op.width2 = width2;
  op.payload = payload;
  op.ct = ct;
  op.red = red_sm + gid * CPL * pl.group;
  op.row0 = dst_row0 + (size_t)b * kChunk;
  op.stride_f = pl.stride / 4;
  op.hc = hc;
  op.h = pl.h;
  op.width = width;
  op.runs = pl.runs;
  op.n_runs = hc / V;
  op.c = c;
  op.group = pl.group;
  op.shuffle = pl.shuffle != 0;
  op.wide = pl.wide != 0;
  op.wide2 = pl.vec == 16;
  op.mask = group_mask(pl.group);
  op.slope = pl.slope;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    op.col[k] = V * (c + pl.group * k);
    op.live[k] = op.col[k] < hc;
    op.head[k] = op.live[k] ? op.col[k] / pl.ch : 0;
    op.first[k] = op.live[k] && op.col[k] == op.head[k] * pl.ch;  // the head's scalars
  }

  for (int r0 = 0, r1; r0 < kChunk; r0 = r1) {
    r1 = whole ? kChunk : group_end(ed.edge_off, r0, pl.list_cap);
    fill_items(planes_b, n_planes, ed, r0, r1,
               cc.item_start - (whole ? 0 : ed.item_off[r0]));
    __syncthreads();
    const int list0 = ed.edge_off[r0];
    const int n_edges = ed.edge_off[r1] - list0;
    expand_items(ed, ed.item_off[r1] - ed.item_off[r0], pl.pack, r0);
    // edges that fit the two buffers together: one batch in both
    const int batch = n_edges <= 2 * pl.batch ? 2 * pl.batch : pl.batch;
    const int n_batches = n_edges > 0 ? (n_edges + batch - 1) / batch : 1;

    auto fetch = [&](int k) {
      const int e0 = k * batch;
      const int n = min(batch, n_edges - e0);
      unsigned char* buf = bufs + (k & 1) * buf_bytes;
      if (!op.wide2)
        gather_rows_covered(buf, pl.stride, reinterpret_cast<const unsigned char*>(g2),
                            (size_t)width2 * 4, width2 * 4, ed.edge + e0, n, n_rows);
      else
        gather(16, buf, pl.stride, g2, (size_t)width2 * 4, 0, width2 * 4, ed.edge + e0, n,
               n_rows);
      cp_async_commit();
    };

    fetch(0);
    int row = r0 + gid;
    bool open = row < r1;  // the group's first row is begun while batch 0 flies
    if (open) op.begin(row);
    for (int k = 0; k < n_batches; ++k) {
      cp_async_wait_all();
      __syncthreads();  // batch k has landed; batch k - 1's buffer is free
      if (k + 1 < n_batches) fetch(k + 1);
      op.e0 = k * batch;
      op.seg = reinterpret_cast<const float*>(bufs + (k & 1) * buf_bytes);
      walk_rows(op, row, open, row_step, r1, ed.edge_off, list0, op.e0,
                min(op.e0 + batch, n_edges), k == n_batches - 1);
    }
    for (int r = r0; r < r1; ++r) {
      const int len = ed.edge_off[r + 1] - ed.edge_off[r];
      if (len > kLongRow)
        op.long_row(r, ed.edge + ed.edge_off[r] - list0, len, gid, row_step,
                    reinterpret_cast<float*>(bufs));
    }
    __syncthreads();  // the list and the buffers are free for the next group
  }
}

template <int CPL, int V, bool kRect>
cudaError_t launch(const uint8_t* a_t, const int32_t* dst_chunk, const int32_t* occ,
                   const float* payload, const float* g2, float* ct, int num_chunks,
                   Plan pl, cudaStream_t stream) {
  pl.red = pl.shuffle ? 0 : round_up(kThreads * CPL * 4, 16);
  const size_t smem = (size_t)pl.area + pl.red + list_bytes(pl.list_cap, pl.depth);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gat_bwd_src_kernel<CPL, V, kRect>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gat_bwd_src_kernel<CPL, V, kRect><<<num_chunks, kThreads, smem, stream>>>(
      a_t, dst_chunk, occ, payload, g2, ct, pl);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The rectangular launch: num_chunks source chunks (a_t, dst_chunk and occ
// at the first of them) whose rows are payload and ct rows dst_row0 ...,
// reading g2's n_rows rows. Returns the cudaError_t of the launch. occ may
// be null.
int gat_bwd_src_launch_rect(const void* a_t, const void* dst_chunk, const void* occ,
                            const void* payload, const void* g2, void* ct,
                            int num_chunks, int depth, int planes, int pack, int h,
                            int ch, int n_rows, int dst_row0, float slope,
                            void* stream) {
  const int hc = h * ch;
  if (num_chunks <= 0 || num_chunks > kMaxRows / kChunk || n_rows <= 0 ||
      n_rows > kMaxRows || dst_row0 < 0 || depth <= 0 ||
      depth > kMaxDepth || h <= 0 || ch <= 0 ||
      hc + 2 * h > kMaxCols || (pack != 1 && pack != 2 && pack != 4) ||
      planes * pack < depth)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* a8 = static_cast<const uint8_t*>(a_t);
  const int32_t* dc = static_cast<const int32_t*>(dst_chunk);
  const int32_t* oc = static_cast<const int32_t*>(occ);
  const float* pay = static_cast<const float*>(payload);
  const float* g = static_cast<const float*>(g2);
  float* o = static_cast<float*>(ct);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan pl = {};
  pl.depth = depth;
  pl.planes = planes;
  pl.pack = pack;
  pl.h = h;
  pl.ch = ch;
  pl.n_rows = n_rows;
  pl.dst_row0 = dst_row0;
  pl.slope = slope;
  const size_t row2_bytes = (size_t)(hc + 3 * h) * 4;
  pl.vec = copy_width(g2, row2_bytes, 16);
  // 16-byte copies either way: of the rows, or of the blocks that cover them
  pl.stride = round_up((hc + 3 * h) * 4 + (pl.vec == 16 ? 0 : 12), 16);
  pl.list_cap = list_cap_for(depth);
  pl.batch = batch_for(pl.stride);
  pl.area = buffer_area(pl.batch, pl.stride, pl.list_cap);
  const int v = ch % 4 == 0 ? 4 : 1;  // adjacent columns a thread holds
  pl.group = group_size(hc / v);
  pl.runs = ch / v;
  pl.shuffle = head_shuffle(pl.runs, pl.group);
  // 16-byte vector loads of xp and stores of d xp
  const size_t row_bytes = (size_t)(hc + 2 * h) * 4;
  pl.wide = copy_width(payload, row_bytes, 16) == 16 && copy_width(ct, row_bytes, 16) == 16;
  const int cpl = (hc / v + 31) / 32;
  const bool rect = n_rows != num_chunks * kChunk || dst_row0 != 0;
  cudaError_t err;
#define GAT_BWD_SRC_CASE(N, V)                                          \
  err = rect ? launch<N, V, true>(a8, dc, oc, pay, g, o, num_chunks, pl, s)  \
             : launch<N, V, false>(a8, dc, oc, pay, g, o, num_chunks, pl, s)
  if (v == 4) {
    if (cpl <= 1) GAT_BWD_SRC_CASE(1, 4);
    else if (cpl <= 2) GAT_BWD_SRC_CASE(2, 4);
    else GAT_BWD_SRC_CASE(4, 4);
  } else if (cpl <= 1) GAT_BWD_SRC_CASE(1, 1);
  else if (cpl <= 2) GAT_BWD_SRC_CASE(2, 1);
  else if (cpl <= 4) GAT_BWD_SRC_CASE(4, 1);
  else if (cpl <= 8) GAT_BWD_SRC_CASE(8, 1);
  else GAT_BWD_SRC_CASE(16, 1);
#undef GAT_BWD_SRC_CASE
  return static_cast<int>(err);
}

// The whole graph: every tensor has the grid's rows.
int gat_bwd_src_launch(const void* a_t, const void* dst_chunk, const void* occ,
                       const void* payload, const void* g2, void* ct,
                       int num_chunks, int depth, int planes, int pack, int h,
                       int ch, float slope, void* stream) {
  return gat_bwd_src_launch_rect(a_t, dst_chunk, occ, payload, g2, ct, num_chunks, depth,
                                 planes, pack, h, ch, num_chunks * kChunk, 0, slope,
                                 stream);
}

const char* gat_bwd_src_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
