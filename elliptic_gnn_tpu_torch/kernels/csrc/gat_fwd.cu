// Flash GAT forward for Hopper (sm_90a): the dense part of the
// per-destination attention softmax over the banded BSDA tables,
//
//     t_ij   = a_dst_i + a_src_j            (per head)
//     m_i    = max_j lrelu(t_ij)            over the row's dense edges
//     e_ij   = mult_ij * exp(lrelu(t_ij) - m_i)
//     s_i    = sum_j e_ij,   acc_i = sum_j e_ij * xp_j
//
// in:  payload [B*128, W] f32 rows [ xp (h*ch) | a_src (h) | a_dst (h) ],
//      W = h*ch + 2h
// out: [B*128, W] f32 rows [ acc (h*ch) | m (h) | s (h) ], or with
//      `normalize` acc / max(s, 1e-16) in the acc columns.
//
// Replaces elliptic_gnn_tpu/kernels/pallas_gat.py::_flash_gat_call (occ
// null: all D slots) and ::_flash_gat_call_gated (occ given: only the
// planes that hold slots 0..occ[b]-1 are read).
//
// What bounds it: bytes (the multiplicity planes, the payload read once,
// the output written once); the arithmetic is h*ch multiply-adds and h
// exps per edge, about two edges a row.
//
// What is not carried over from the TPU kernels, and why:
// - They run dense 128x128 score tiles on the MXU and use a rank-1
//   separable exp to spare the VPU. Here only the edges are listed and
//   walked (bsda_edges.cuh) and exp(lrelu(t) - m) is computed per edge.
// - The softmax shift. The TPU kernels take m = lrelu(a_dst_i + max a_src)
//   over all 128 rows of each source chunk, neighbours or not: an upper
//   bound that lets every true edge underflow when a_src spreads widely
//   inside a chunk. Walking edges gives the exact max over the row's own
//   edges (pass 1), so e <= mult and the largest term is exactly mult.
//   Everything downstream is invariant to the shift: compare acc / s and
//   m + log s with another gauge, never m or s alone.
// - No grid order, no DMA ring, no 128-lane padding of the payload: each
//   block fetches the source rows it needs through L2, where the band
//   (|chunk(i) - chunk(j)| small) keeps them.
//
// Rows with no dense edge (padding, occ 0, all edges spilled) write
// s = 0, acc = 0 and m = -1e30, finite so that the spill merge's
// exp(m1 - max(m1, m2)) is never inf - inf.
//
// Design (bsda_edges.cuh): one block per destination chunk. The block lists
// the chunk's edges once (source row and multiplicity in a word, per-row
// offsets; with occ only the covered planes are read), fetches its own rows'
// a_dst into shared memory, then fetches every edge's
// [ xp | a_src ] segment of the payload into shared memory with cp.async,
// all copies of a batch in flight at once and the next batch's in flight
// while this one is summed. A thread group owns a row and a thread CPL runs
// of V adjacent columns of it (V = 4 where ch is a multiple of 4, else 1);
// the group is the smallest power of two that holds the runs, so that at
// (h, ch) = (1, 2) a warp works on 16 rows at once and at (4, 8) on four.
// A run belongs to one head and keeps that head's m and s itself, so no
// thread needs another's value.
// Per row and batch: pass 1 takes the max of a_src over the row's edges
// from shared memory (lrelu is monotonic), pass 2 accumulates s and acc in
// list order, so the sums are deterministic. A row whose edges straddle
// two batches (a hub) carries m, s and acc in registers and rescales them
// by exp(m_old - m_new) when the max grows; its m still ends as the exact
// row max. f32 throughout.
//
// Plain C interface, loaded with ctypes (kernels/gat_cuda.py).

#include <math.h>

#include "bsda_edges.cuh"

namespace {

using namespace bsda;

constexpr int kMaxCols = 512;      // h * ch + 2 h <= 512
constexpr float kNegInf = -1e30f;  // the package's NEG_INF

__device__ __forceinline__ float lrelu(float t, float slope) {
  return t >= 0.f ? t : t * slope;
}

// What the launch fixes for every block.
struct Plan {
  int depth, planes, pack, h, ch, normalize;
  float slope;
  int vec;       // copy width of the payload gather in bytes (16, 8 or 4)
  int list_cap;  // edges a list holds
  int batch;     // edges a gather buffer holds
  int stride;    // bytes between two edges' segments in a buffer
  int group;     // threads that share a row
  int area;      // bytes of the two gather buffers, at least the list's items
};

// One row's softmax sums: the state of a thread, for its CPL runs of V
// adjacent columns (V = 4 when ch is a multiple of 4, so that a run lies in
// one head and is one 16-byte read; else 1).
template <int CPL, int V>
struct RowSoftmax {
  const float* seg;    // this batch's buffer
  const uint32_t* edge;
  const float* adst_sm;    // [128, h] a_dst of the chunk's rows
  float* out_b;            // out at row 0 of the chunk
  int stride_f, e0, hc, h, width, normalize;
  float slope;
  bool wide_store;     // rows of out are 16-byte aligned
  int col[CPL], head[CPL];
  bool live[CPL];
  float adst[CPL], m[CPL], s[CPL], acc[CPL][V];

  __device__ __forceinline__ void begin(int row) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      adst[k] = live[k] ? adst_sm[row * h + head[k]] : 0.f;
      m[k] = -INFINITY;
      s[k] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[k][v] = 0.f;
    }
  }

  __device__ __forceinline__ void edges(int lo, int hi) {
    if (lo >= hi) return;
    float mx[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) mx[k] = -INFINITY;
    for (int e = lo; e < hi; ++e) {
      const float* p = seg + (size_t)(e - e0) * stride_f + hc;
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        if (live[k]) mx[k] = fmaxf(mx[k], p[head[k]]);
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (!live[k]) continue;
      const float m_new = fmaxf(m[k], lrelu(adst[k] + mx[k], slope));
      // a row begun in an earlier batch: its sums move to the new shift
      const float keep = m[k] > -INFINITY ? expf(m[k] - m_new) : 0.f;
      s[k] *= keep;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[k][v] *= keep;
      m[k] = m_new;
    }
    for (int e = lo; e < hi; ++e) {
      const float* p = seg + (size_t)(e - e0) * stride_f;
      const float mu = static_cast<float>(edge[e] >> 24);
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (!live[k]) continue;
        const float t = adst[k] + p[hc + head[k]];
        const float w = mu * expf(lrelu(t, slope) - m[k]);
        s[k] += w;
        if constexpr (V == 4) {
          const float4 x = *reinterpret_cast<const float4*>(p + col[k]);
          acc[k][0] += w * x.x;
          acc[k][1] += w * x.y;
          acc[k][2] += w * x.z;
          acc[k][3] += w * x.w;
        } else {
          acc[k][0] += w * p[col[k]];
        }
      }
    }
  }

  __device__ __forceinline__ void end(int row) {
    float* o = out_b + (size_t)row * width;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (!live[k]) continue;
      const float div = normalize ? fmaxf(s[k], 1e-16f) : 1.f;
      float val[V];
#pragma unroll
      for (int v = 0; v < V; ++v) val[v] = normalize ? acc[k][v] / div : acc[k][v];
      if constexpr (V == 4) {
        if (wide_store) {
          *reinterpret_cast<float4*>(o + col[k]) =
              make_float4(val[0], val[1], val[2], val[3]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) o[col[k] + v] = val[v];
        }
      } else {
        o[col[k]] = val[0];
      }
      if (col[k] == head[k] * (hc / h)) {  // the head's first run writes its m and s
        o[hc + head[k]] = m[k] > -INFINITY ? m[k] : kNegInf;
        o[hc + h + head[k]] = s[k];
      }
    }
  }
};

template <int CPL, int V>
__global__ void __launch_bounds__(kThreads, (CPL * V <= 4 ? kMinBlocks : 1))
gat_fwd_kernel(const uint8_t* __restrict__ a,          // [B, planes, C, C]
               const int32_t* __restrict__ src_chunk,  // [B, depth]
               const int32_t* __restrict__ occ,        // [B] or null
               const float* __restrict__ payload,      // [B*C, W]
               float* __restrict__ out,                // [B*C, W]
               const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [2 gather buffers, under them the list's items | a_dst of the chunk's
  // rows | edge list]
  const size_t buf_bytes = (size_t)pl.batch * pl.stride;
  unsigned char* bufs = smem;
  float* adst_sm = reinterpret_cast<float*>(smem + pl.area);
  const EdgeList ed = make_list(
      reinterpret_cast<unsigned char*>(adst_sm + kChunk * pl.h), smem, pl.list_cap);

  const int b = blockIdx.x;
  const int hc = pl.h * pl.ch;
  const int width = hc + 2 * pl.h;
  // slots at and beyond occ[b] are all zero: their planes are not read
  const int slots = occ != nullptr ? min(occ[b], pl.depth) : pl.depth;
  const int n_planes = (slots + pl.pack - 1) / pl.pack;
  const uint32_t* planes_b = reinterpret_cast<const uint32_t*>(
      a + (size_t)b * pl.planes * (size_t)kPlaneBytes);
  for (int idx = threadIdx.x; idx < kChunk * pl.h; idx += kThreads) {
    const int row = idx / pl.h;
    cp_async<4>(adst_sm + idx, payload + ((size_t)b * kChunk + row) * width + hc +
                                   pl.h + (idx - row * pl.h));
  }
  const ChunkCounts cc = count_rows(planes_b, n_planes, pl.pack,
                                    src_chunk + (size_t)b * pl.depth, pl.depth, ed);
  const bool whole = cc.edges <= pl.list_cap;  // the rule: one list for the chunk
  if (!whole) __syncthreads();                 // a hub chunk: the offsets, for group_end

  const int gid = threadIdx.x / pl.group;
  const int c = threadIdx.x % pl.group;
  const int row_step = kThreads / pl.group;
  const int n_rows = gridDim.x * kChunk;

  RowSoftmax<CPL, V> op;
  op.edge = ed.edge;
  op.adst_sm = adst_sm;
  op.out_b = out + (size_t)b * kChunk * width;
  op.stride_f = pl.stride / 4;
  op.hc = hc;
  op.h = pl.h;
  op.width = width;
  op.normalize = pl.normalize;
  op.slope = pl.slope;
  op.wide_store = width % 4 == 0;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    op.col[k] = V * (c + pl.group * k);
    op.live[k] = op.col[k] < hc;
    op.head[k] = op.live[k] ? op.col[k] / pl.ch : 0;
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
      gather(pl.vec, bufs + (k & 1) * buf_bytes, pl.stride, payload,
             (size_t)width * 4, 0, (hc + pl.h) * 4, ed.edge + e0,
             min(batch, n_edges - e0), n_rows);
      cp_async_commit();
    };

    fetch(0);
    int row = r0 + gid;
    bool open = false;
    for (int k = 0; k < n_batches; ++k) {
      cp_async_wait_all();
      __syncthreads();  // batch k has landed; batch k - 1's buffer is free
      if (k + 1 < n_batches) fetch(k + 1);
      op.e0 = k * batch;
      op.seg = reinterpret_cast<const float*>(bufs + (k & 1) * buf_bytes);
      walk_rows(op, row, open, row_step, r1, ed.edge_off, list0, op.e0,
                min(op.e0 + batch, n_edges), k == n_batches - 1);
    }
    __syncthreads();  // the list and the buffers are free for the next group
  }
}

template <int CPL, int V>
cudaError_t launch(const uint8_t* a, const int32_t* src_chunk, const int32_t* occ,
                   const float* payload, float* out, int num_chunks, const Plan& pl,
                   cudaStream_t stream) {
  const size_t smem = (size_t)pl.area + (size_t)kChunk * pl.h * 4 +
                      list_bytes(pl.list_cap, pl.depth);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gat_fwd_kernel<CPL, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gat_fwd_kernel<CPL, V><<<num_chunks, kThreads, smem, stream>>>(
      a, src_chunk, occ, payload, out, pl);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch. occ may be null.
int gat_fwd_launch(const void* a, const void* src_chunk, const void* occ,
                   const void* payload, void* out, int num_chunks, int depth,
                   int planes, int pack, int h, int ch, float slope,
                   int normalize, void* stream) {
  const int hc = h * ch;
  if (num_chunks <= 0 || num_chunks > kMaxRows / kChunk || depth <= 0 ||
      depth > kMaxDepth || h <= 0 || ch <= 0 ||
      hc + 2 * h > kMaxCols || (pack != 1 && pack != 2 && pack != 4) ||
      planes * pack < depth)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const int32_t* sc = static_cast<const int32_t*>(src_chunk);
  const int32_t* oc = static_cast<const int32_t*>(occ);
  const float* pay = static_cast<const float*>(payload);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan pl = {};
  pl.depth = depth;
  pl.planes = planes;
  pl.pack = pack;
  pl.h = h;
  pl.ch = ch;
  pl.normalize = normalize;
  pl.slope = slope;
  const size_t row_bytes = (size_t)(hc + 2 * h) * 4;
  pl.vec = copy_width(payload, row_bytes, 16);
  // whole pieces of the copy width: the last may take in a_dst columns
  pl.stride = round_up((hc + h) * 4, 16);
  pl.list_cap = list_cap_for(depth);
  pl.batch = batch_for(pl.stride);
  pl.area = buffer_area(pl.batch, pl.stride, pl.list_cap);
  const int v = ch % 4 == 0 ? 4 : 1;  // adjacent columns a thread reads at once
  pl.group = group_size(hc / v);
  const int cpl = (hc / v + 31) / 32;
  cudaError_t err;
#define GAT_FWD_CASE(N, V) err = launch<N, V>(a8, sc, oc, pay, o, num_chunks, pl, s)
  if (v == 4) {
    if (cpl <= 1) GAT_FWD_CASE(1, 4);
    else if (cpl <= 2) GAT_FWD_CASE(2, 4);
    else GAT_FWD_CASE(4, 4);
  } else if (cpl <= 1) GAT_FWD_CASE(1, 1);
  else if (cpl <= 2) GAT_FWD_CASE(2, 1);
  else if (cpl <= 4) GAT_FWD_CASE(4, 1);
  else if (cpl <= 8) GAT_FWD_CASE(8, 1);
  else GAT_FWD_CASE(16, 1);
#undef GAT_FWD_CASE
  return static_cast<int>(err);
}

const char* gat_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
