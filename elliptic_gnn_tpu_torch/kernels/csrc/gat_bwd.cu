// Flash GAT backward for Hopper (sm_90a): the vector-Jacobian product of
// gat_fwd.cu's dense part, one sweep over the forward tables,
//
//     e_ij     = mult_ij * exp(lrelu(t_ij) - m_i),  t_ij = a_dst_i + a_src_j
//     d xp_j   = sum_i e_ij * A_i
//     dt_ij    = e_ij * lrelu'(t_ij) * (xp_j . A_i + S_i)
//     d a_dst_i = sum_j dt_ij,   d a_src_j = sum_i dt_ij
//
// where (A_i, S_i) are the cotangents of (acc_i, s_i) at fixed m_i.
//
// in:  gbar    [B*128, W] cotangent of the forward's output (acc columns
//              and s columns are read; the m columns never are: the shift
//              is a constant of the backward),
//      payload [n_rows, W] the forward's input [ xp | a_src | a_dst ],
//      out_k   [B*128, W] the forward's output: its m columns give the
//              same m, and so the same e, as the forward; with
//              `normalized` its acc columns hold val = acc / s and gbar is
//              the cotangent of (val, s), turned into (A, S) per row in
//              registers: A = gbar / s, S = gbar_s - (gbar . val) / s,
//              with 1 / max(s, 1e-16).
// out: ct [n_rows, W] rows [ d xp | d a_src | d a_dst ], zeroed by the
//      caller before the launch.
//
// The rectangular launch (gat_bwd_launch_rect), as gat_fwd.cu's: the grid's
// destination rows are payload rows dst_row0 ...; their a_dst is read and
// their d a_dst written there, their gbar and out_k rows are the grid's
// own (row 0 = the grid's first row), and the per-source columns go to any
// of ct's n_rows rows.
//
// Replaces elliptic_gnn_tpu/kernels/pallas_gat_bwd.py::_sweep_fused_call
// together with the assembly in ::flash_gat_backward3: the z1/z2 rows, the
// transpose and the xp . z2 contraction there are how the TPU kernel got
// around its layout, not part of the function.
//
// What bounds it: bytes (planes, three [N, W] inputs read once, one output
// written once); per edge it does 3 h ch multiply-adds and h exps, about
// two edges a row.
//
// Design (bsda_edges.cuh, as gat_fwd.cu): one block per destination chunk.
// The block lists the chunk's edges once (with occ only the covered planes
// are read), then fetches every edge's [ xp | a_src ] segment of the
// payload into shared memory with cp.async, all copies of a batch in flight
// at once and the next batch's while this one is walked. A thread group
// owns a row and a thread CPL runs of V adjacent columns of it (V = 4 where
// ch is a multiple of 4, else 1). At row begin the row reads its a_dst, m,
// A and S (and, normalized, val and s) from global memory: a group's first
// row while the first batch is in flight. Per edge: e and the gate per run,
// q = xp_j . A_i summed over the head's runs by xor shuffles inside the
// group where a head's runs are a power of two of lanes (else through a
// scratch row of the group), dt.
//
// The TPU kernel keeps the per-source sums in a revolving VMEM accumulator
// because its grid runs in order. Blocks here run in any order, so d xp_j
// and d a_src_j, which gather over rows of other blocks, are added with
// atomics into the zeroed output: one 16-byte vector atomicAdd (sm_90's
// float4 atomicAdd) per run of 4 columns where the output's rows are
// 16-byte aligned, scalar f32 atomicAdds otherwise, and one per head for
// d a_src. Their order, and so the last bits of those columns, changes from
// run to run. d a_dst_i is a sum over the row's own edges: registers, in
// list order, one plain store, the same bits every launch. Rows whose edges
// straddle two gather batches (hubs) carry their state in registers; no
// rescale, m is the forward's. Any (h, ch) with h*ch + 2h <= 512.
//
// Plain C interface, loaded with ctypes (kernels/gat_cuda.py).

#include <math.h>

#include "bsda_edges.cuh"

namespace {

using namespace bsda;

constexpr int kMaxCols = 512;  // h * ch + 2 h <= 512

__device__ __forceinline__ float lrelu(float t, float slope) {
  return t >= 0.f ? t : t * slope;
}

// What the launch fixes for every block.
struct Plan {
  int depth, planes, pack, h, ch, normalized;
  float slope;
  int vec;       // copy width of the payload gather in bytes (16, 8 or 4)
  int list_cap;  // edges a list holds
  int batch;     // edges a gather buffer holds
  int stride;    // bytes between two edges' segments in a buffer
  int group;     // threads that share a row
  int area;      // bytes of the two gather buffers, at least the list's items
  int runs;      // runs of V columns a head holds
  int shuffle;   // head sums by xor shuffles (else a scratch row a group)
  int red;       // bytes of the groups' scratch rows (0 with shuffle)
  int wide;      // rows of ct and gbar are 16-byte aligned
  int n_rows;    // payload (and ct) rows the gathers may read
  int dst_row0;  // payload row of the grid's first destination row
};

// One destination row's backward: the state of a thread, for its CPL runs.
template <int CPL, int V>
struct RowVjp {
  const float* seg;  // this batch's buffer: per edge [ xp | a_src ] of its source
  const uint32_t* edge;
  const float* gbar;
  const float* payload;
  const float* out_k;
  float* ct;
  float* red;  // the group's scratch row
  size_t row0;   // the chunk's first row in gbar and out_k
  size_t prow0;  // the chunk's first row in payload and ct
  int stride_f, e0, hc, h, width, normalized, runs, n_runs, c, group;
  bool shuffle, wide;
  unsigned mask;
  float slope;
  int col[CPL], head[CPL];
  bool live[CPL], first[CPL];
  float abar[CPL][V], sbar[CPL], adst[CPL], m[CPL], dadst[CPL];

  __device__ __forceinline__ void load_run(float (&v)[V], const float* p) const {
    if constexpr (V == 4) {
      if (wide) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        return;
      }
    }
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = __ldg(p + u);
  }

  __device__ __forceinline__ void begin(int row) {
    const size_t base = (row0 + row) * width;
    float part[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      part[k] = 0.f;
      dadst[k] = 0.f;
      if (!live[k]) continue;
      adst[k] = __ldg(payload + (prow0 + row) * width + hc + h + head[k]);
      m[k] = __ldg(out_k + base + hc + head[k]);
      sbar[k] = __ldg(gbar + base + hc + h + head[k]);
      load_run(abar[k], gbar + base + col[k]);
      if (normalized) {
        float val[V];
        load_run(val, out_k + base + col[k]);
#pragma unroll
        for (int u = 0; u < V; ++u) part[k] += abar[k][u] * val[u];
      }
    }
    if (!normalized) return;
    head_sums<CPL>(part, shuffle, runs, n_runs, c, group, mask, red);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (!live[k]) continue;
      const float inv_s = 1.f / fmaxf(__ldg(out_k + base + hc + h + head[k]), 1e-16f);
#pragma unroll
      for (int u = 0; u < V; ++u) abar[k][u] *= inv_s;
      sbar[k] -= part[k] * inv_s;
    }
  }

  __device__ __forceinline__ void edges(int lo, int hi) {
    for (int e = lo; e < hi; ++e) {
      const float* p = seg + (size_t)(e - e0) * stride_f;
      const uint32_t w = edge[e];
      const float mu = static_cast<float>(w >> 24);
      float ev[CPL], gate[CPL], q[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        ev[k] = gate[k] = q[k] = 0.f;
        if (!live[k]) continue;
        const float t = adst[k] + p[hc + head[k]];
        // the forward's m makes the exponent <= 0; the clamp matches the
        // plain closed form
        ev[k] = mu * expf(fminf(lrelu(t, slope) - m[k], 0.f));
        gate[k] = t >= 0.f ? 1.f : slope;
        if constexpr (V == 4) {
          const float4 x = *reinterpret_cast<const float4*>(p + col[k]);
          q[k] = x.x * abar[k][0] + x.y * abar[k][1] + x.z * abar[k][2] + x.w * abar[k][3];
        } else {
          q[k] = p[col[k]] * abar[k][0];
        }
      }
      head_sums<CPL>(q, shuffle, runs, n_runs, c, group, mask, red);
      float* o = ct + (size_t)(w & kRowMask) * width;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (!live[k]) continue;
        const float dt = ev[k] * gate[k] * (q[k] + sbar[k]);
        dadst[k] += dt;
        if constexpr (V == 4) {
          if (wide) {
            atomicAdd(reinterpret_cast<float4*>(o + col[k]),
                      make_float4(ev[k] * abar[k][0], ev[k] * abar[k][1],
                                  ev[k] * abar[k][2], ev[k] * abar[k][3]));
          } else {
#pragma unroll
            for (int u = 0; u < V; ++u) atomicAdd(o + col[k] + u, ev[k] * abar[k][u]);
          }
        } else {
          atomicAdd(o + col[k], ev[k] * abar[k][0]);
        }
        if (first[k]) atomicAdd(o + hc + head[k], dt);
      }
    }
  }

  __device__ __forceinline__ void end(int row) {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (first[k]) ct[(prow0 + row) * width + hc + h + head[k]] = dadst[k];
  }
};

template <int CPL, int V, bool kRect>
__global__ void __launch_bounds__(kThreads, (CPL == 1 ? kMinBlocks : 1))
gat_bwd_kernel(const uint8_t* __restrict__ a,          // [B, planes, C, C]
               const int32_t* __restrict__ src_chunk,  // [B, depth]
               const int32_t* __restrict__ occ,        // [B] or null
               const float* __restrict__ gbar,         // [B*C, W]
               const float* __restrict__ payload,      // [B*C, W]
               const float* __restrict__ out_k,        // [B*C, W]
               float* __restrict__ ct,                 // [B*C, W], zeroed
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
  // slots at and beyond occ[b] are all zero: their planes are not read
  const int slots = occ != nullptr ? min(occ[b], pl.depth) : pl.depth;
  const int n_planes = (slots + pl.pack - 1) / pl.pack;
  const uint32_t* planes_b = reinterpret_cast<const uint32_t*>(
      a + (size_t)b * pl.planes * (size_t)kPlaneBytes);
  const ChunkCounts cc = count_rows(planes_b, n_planes, pl.pack,
                                    src_chunk + (size_t)b * pl.depth, pl.depth, ed);
  const bool whole = cc.edges <= pl.list_cap;  // the rule: one list for the chunk
  if (!whole) __syncthreads();                 // a hub chunk: the offsets, for group_end

  const int gid = threadIdx.x / pl.group;
  const int c = threadIdx.x % pl.group;
  const int row_step = kThreads / pl.group;
  const int n_rows = kRect ? pl.n_rows : gridDim.x * kChunk;

  RowVjp<CPL, V> op;
  op.edge = ed.edge;
  op.gbar = gbar;
  op.payload = payload;
  op.out_k = out_k;
  op.ct = ct;
  op.red = red_sm + gid * CPL * pl.group;
  op.row0 = (size_t)b * kChunk;
  op.prow0 = dst_row0 + op.row0;
  op.stride_f = pl.stride / 4;
  op.hc = hc;
  op.h = pl.h;
  op.width = width;
  op.normalized = pl.normalized;
  op.runs = pl.runs;
  op.n_runs = hc / V;
  op.c = c;
  op.group = pl.group;
  op.shuffle = pl.shuffle != 0;
  op.wide = pl.wide != 0;
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
      gather(pl.vec, bufs + (k & 1) * buf_bytes, pl.stride, payload,
             (size_t)width * 4, 0, (hc + pl.h) * 4, ed.edge + e0,
             min(batch, n_edges - e0), n_rows);
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
    __syncthreads();  // the list and the buffers are free for the next group
  }
}

template <int CPL, int V, bool kRect>
cudaError_t launch(const uint8_t* a, const int32_t* src_chunk, const int32_t* occ,
                   const float* gbar, const float* payload, const float* out_k,
                   float* ct, int num_chunks, Plan pl, cudaStream_t stream) {
  pl.red = pl.shuffle ? 0 : round_up(kThreads * CPL * 4, 16);
  const size_t smem = (size_t)pl.area + pl.red + list_bytes(pl.list_cap, pl.depth);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gat_bwd_kernel<CPL, V, kRect>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gat_bwd_kernel<CPL, V, kRect><<<num_chunks, kThreads, smem, stream>>>(
      a, src_chunk, occ, gbar, payload, out_k, ct, pl);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The rectangular launch: num_chunks destination chunks (a, src_chunk and
// occ at the first of them) whose rows are payload rows dst_row0 ...; gbar
// and out_k hold the grid's num_chunks * 128 rows, payload and ct n_rows.
// Returns the cudaError_t of the launch. occ may be null; ct must be zero.
int gat_bwd_launch_rect(const void* a, const void* src_chunk, const void* occ,
                        const void* gbar, const void* payload, const void* out_k,
                        void* ct, int num_chunks, int depth, int planes, int pack,
                        int h, int ch, int n_rows, int dst_row0, float slope,
                        int normalized, void* stream) {
  const int hc = h * ch;
  if (num_chunks <= 0 || num_chunks > kMaxRows / kChunk || n_rows <= 0 ||
      n_rows > kMaxRows || dst_row0 < 0 ||
      (long long)dst_row0 + (long long)num_chunks * kChunk > n_rows || depth <= 0 ||
      depth > kMaxDepth || h <= 0 || ch <= 0 ||
      hc + 2 * h > kMaxCols || (pack != 1 && pack != 2 && pack != 4) ||
      planes * pack < depth)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const int32_t* sc = static_cast<const int32_t*>(src_chunk);
  const int32_t* oc = static_cast<const int32_t*>(occ);
  const float* gb = static_cast<const float*>(gbar);
  const float* pay = static_cast<const float*>(payload);
  const float* ok = static_cast<const float*>(out_k);
  float* o = static_cast<float*>(ct);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan pl = {};
  pl.depth = depth;
  pl.planes = planes;
  pl.pack = pack;
  pl.h = h;
  pl.ch = ch;
  pl.normalized = normalized;
  pl.n_rows = n_rows;
  pl.dst_row0 = dst_row0;
  pl.slope = slope;
  const size_t row_bytes = (size_t)(hc + 2 * h) * 4;
  pl.vec = copy_width(payload, row_bytes, 16);
  // whole pieces of the copy width: the last may take in a_dst columns
  pl.stride = round_up((hc + h) * 4, 16);
  pl.list_cap = list_cap_for(depth);
  pl.batch = batch_for(pl.stride);
  pl.area = buffer_area(pl.batch, pl.stride, pl.list_cap);
  const int v = ch % 4 == 0 ? 4 : 1;  // adjacent columns a thread holds
  pl.group = group_size(hc / v);
  pl.runs = ch / v;
  pl.shuffle = head_shuffle(pl.runs, pl.group);
  // 16-byte vector loads of gbar and out_k, vector atomics into ct
  pl.wide = row_bytes % 16 == 0 && copy_width(gbar, row_bytes, 16) == 16 &&
            copy_width(out_k, row_bytes, 16) == 16 && copy_width(ct, row_bytes, 16) == 16;
  const int cpl = (hc / v + 31) / 32;
  const bool rect = n_rows != num_chunks * kChunk || dst_row0 != 0;
  cudaError_t err;
#define GAT_BWD_CASE(N, V)                                          \
  err = rect ? launch<N, V, true>(a8, sc, oc, gb, pay, ok, o, num_chunks, pl, s)  \
             : launch<N, V, false>(a8, sc, oc, gb, pay, ok, o, num_chunks, pl, s)
  if (v == 4) {
    if (cpl <= 1) GAT_BWD_CASE(1, 4);
    else if (cpl <= 2) GAT_BWD_CASE(2, 4);
    else GAT_BWD_CASE(4, 4);
  } else if (cpl <= 1) GAT_BWD_CASE(1, 1);
  else if (cpl <= 2) GAT_BWD_CASE(2, 1);
  else if (cpl <= 4) GAT_BWD_CASE(4, 1);
  else if (cpl <= 8) GAT_BWD_CASE(8, 1);
  else GAT_BWD_CASE(16, 1);
#undef GAT_BWD_CASE
  return static_cast<int>(err);
}

// The whole graph: every tensor has the grid's rows.
int gat_bwd_launch(const void* a, const void* src_chunk, const void* occ,
                   const void* gbar, const void* payload, const void* out_k,
                   void* ct, int num_chunks, int depth, int planes, int pack,
                   int h, int ch, float slope, int normalized, void* stream) {
  return gat_bwd_launch_rect(a, src_chunk, occ, gbar, payload, out_k, ct, num_chunks,
                             depth, planes, pack, h, ch, num_chunks * kChunk, 0, slope,
                             normalized, stream);
}

const char* gat_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
