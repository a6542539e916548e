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
// Tables: aT[J, slot] = a[I, d] for every nonzero forward block (I, d) whose
// source chunk is J, UNtransposed (rows = destinations of chunk
// srcT[J, slot] = I, columns = sources of chunk J), bit-packed like the
// forward planes; occT[J] slots are filled, the rest are zero blocks that
// point at J itself.
//
// in:  payload [B*128, W] own rows: the forward's input [ xp | a_src | a_dst ],
//              of which xp and a_src are read,
//      g2      [B*128, W2] streamed rows [ A (h*ch) | S (h) | a_dst (h) | m (h) ],
//              W2 = h*ch + 3h: m is the forward's, so e is the forward's.
// out: ct [B*128, W]: the d xp and d a_src columns (0 .. h*ch + h) of every
//      row are written; the d a_dst columns belong to gat_bwd_dst.cu.
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
// The column walk. A source j owns a COLUMN of each staged plane, while the
// other GAT kernels ballot along rows. Here the lanes stand for destination
// rows: for column j lane l reads the bytes of rows l, l+32, l+64, l+96, a
// ballot finds the rows that hold an edge, and the warp walks those
// together (gat_common.cuh for_each_edge_in_column). The planes are staged
// with rows padded to 33 words so that such a column read touches 32
// different banks. Transposing each plane in shared memory instead would
// keep the row walk but cost a second 16 KB pass of byte scatters per
// plane; the padded column read costs four conflict-free loads per plane
// and column.
//
// Reproducibility: d xp_j and d a_src_j are sums over the edges out of j,
// kept in registers by the one warp that owns source j and taken in the
// fixed order of the walk (plane, destination row, slot); plain stores. No
// atomics: two launches on the same inputs give the same bits.
//
// Design: one block per SOURCE chunk, warp w owns sources 16w..16w+15, lane
// l owns columns l, l+32, ... of xp; the slot cover occT limits the planes
// staged. Any (h, ch) with h*ch + 2h <= 512.
//
// Plain C interface, loaded with ctypes (kernels/gat_cuda.py).

#include <math.h>

#include "gat_common.cuh"

namespace {

using namespace gat;

template <int CPL>
__global__ void __launch_bounds__(kThreads)
gat_bwd_src_kernel(const uint8_t* __restrict__ a_t,        // [B, planes, C, C]
                   const int32_t* __restrict__ dst_chunk,  // [B, depth]
                   const int32_t* __restrict__ occ,        // [B] or null
                   const float* __restrict__ payload,      // [B*C, W]
                   const float* __restrict__ g2,           // [B*C, W2]
                   float* __restrict__ ct,                 // [B*C, W]
                   int depth, int planes, int pack, int h, int ch, float slope) {
  extern __shared__ __align__(16) uint32_t planes_sm[];  // n_planes * 16.5 KB
  __shared__ int32_t dst_sm[kMaxDepth];
  __shared__ float red_sm[kWarps][CPL * 32];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hc = h * ch;
  const int width = hc + 2 * h;
  const int width2 = hc + 3 * h;
  const int n_planes = planes_needed(occ, b, depth, pack);
  stage_tables_cols(planes_sm, dst_sm, a_t, dst_chunk, b, depth, planes, n_planes);
  float* red = red_sm[warp];

  int head[CPL];
  bool live[CPL], first[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    live[k] = c < hc;
    head[k] = live[k] ? c / ch : 0;
    first[k] = live[k] && c == head[k] * ch;  // carries the head's scalars
  }

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int j = warp * kRowsPerWarp + r;
    const size_t row = (size_t)b * kChunk + j;
    const float* own = payload + row * width;
    float xp[CPL], asrc[CPL], dxp[CPL], dasrc[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      xp[k] = live[k] ? __ldg(own + lane + 32 * k) : 0.f;
      asrc[k] = live[k] ? __ldg(own + hc + head[k]) : 0.f;
      dxp[k] = dasrc[k] = 0.f;
    }
    for_each_edge_in_column(
        planes_sm, dst_sm, n_planes, pack, j, lane,
        [&](int dst_row, float mult) {
          const float* d = g2 + (size_t)dst_row * width2;
          float e[CPL], abar[CPL], part[CPL], q[CPL];
          bool pos[CPL];
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            e[k] = abar[k] = part[k] = 0.f;
            pos[k] = true;
            if (!live[k]) continue;
            const float t = __ldg(d + hc + h + head[k]) + asrc[k];
            // the forward's m makes the exponent <= 0; the clamp matches
            // the plain closed form
            e[k] = mult * expf(fminf(
                lrelu(t, slope) - __ldg(d + hc + 2 * h + head[k]), 0.f));
            pos[k] = t >= 0.f;
            abar[k] = __ldg(d + lane + 32 * k);
            part[k] = xp[k] * abar[k];
          }
          head_sum<CPL>(red, part, q, head, live, lane, ch);
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            if (!live[k]) continue;
            dxp[k] += e[k] * abar[k];
            dasrc[k] += e[k] * (pos[k] ? 1.f : slope) *
                        (q[k] + __ldg(d + hc + head[k]));
          }
        });
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (!live[k]) continue;
      ct[row * width + lane + 32 * k] = dxp[k];
      if (first[k]) ct[row * width + hc + head[k]] = dasrc[k];
    }
  }
}

template <int CPL>
cudaError_t launch(const uint8_t* a_t, const int32_t* dst_chunk, const int32_t* occ,
                   const float* payload, const float* g2, float* ct,
                   int num_chunks, int depth, int planes, int pack, int h, int ch,
                   float slope, cudaStream_t stream) {
  const size_t smem = (size_t)planes * kColPlaneWords * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      gat_bwd_src_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gat_bwd_src_kernel<CPL><<<num_chunks, kThreads, smem, stream>>>(
      a_t, dst_chunk, occ, payload, g2, ct, depth, planes, pack, h, ch, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch. occ may be null.
int gat_bwd_src_launch(const void* a_t, const void* dst_chunk, const void* occ,
                       const void* payload, const void* g2, void* ct,
                       int num_chunks, int depth, int planes, int pack, int h,
                       int ch, float slope, void* stream) {
  const int hc = h * ch;
  if (num_chunks <= 0 || depth <= 0 || depth > kMaxDepth || h <= 0 || ch <= 0 ||
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
  const int cpl = (hc + 31) / 32;
  cudaError_t err;
#define GAT_BWD_SRC_CASE(N)                                                      \
  err = launch<N>(a8, dc, oc, pay, g, o, num_chunks, depth, planes, pack, h, ch, \
                  slope, s)
  if (cpl <= 1) GAT_BWD_SRC_CASE(1);
  else if (cpl <= 2) GAT_BWD_SRC_CASE(2);
  else if (cpl <= 4) GAT_BWD_SRC_CASE(4);
  else if (cpl <= 8) GAT_BWD_SRC_CASE(8);
  else GAT_BWD_SRC_CASE(16);
#undef GAT_BWD_SRC_CASE
  return static_cast<int>(err);
}

const char* gat_bwd_src_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
