// Flash GAT backward, destination sweep, for Hopper (sm_90a): the
// destination-side half of the two-sweep vector-Jacobian product of
// gat_fwd.cu's dense part, over the FORWARD tables,
//
//     e_ij      = mult_ij * exp(lrelu(t_ij) - m_i),  t_ij = a_dst_i + a_src_j
//     d a_dst_i = sum_j e_ij * lrelu'(t_ij) * (xp_j . A_i + S_i)
//
// where (A_i, S_i) are the cotangents of (acc_i, s_i) at fixed m_i, in the
// raw gauge (kernels/gat_bwd.py::grad_payload turns a cotangent of the
// normalized output into them, once, for both sweeps).
//
// in:  g2      [B*128, W2] own rows [ A (h*ch) | S (h) | a_dst (h) | m (h) ],
//              W2 = h*ch + 3h: m is the forward's, so e is the forward's,
//      payload [B*128, W] streamed rows: the forward's input
//              [ xp | a_src | a_dst ], of which xp and a_src are read.
// out: ct [B*128, W]: the d a_dst columns (h*ch + h .. h*ch + 2h) of every
//      row are written; the other columns belong to gat_bwd_src.cu.
//
// Replaces elliptic_gnn_tpu/kernels/pallas_gat_bwd.py::_sweep_dst_call. Not
// carried over: the VMEM ring of payload chunks, the 128-lane padding, the
// rank-1 separable exponent and the MXU "rowdot" over dense 128x128 blocks.
// Only the edges are walked (gat_common.cuh) and e is computed per edge.
//
// What bounds it: bytes (planes, g2 and the payload's xp and a_src columns
// read once, h columns written); per edge 2 h ch multiply-adds and h exps.
//
// Reproducibility: every d a_dst_i is a sum over row i's own edges, kept in
// registers by the one warp that owns the row and taken in the fixed order
// of the walk (plane, column, slot); one plain store per head. No atomics:
// two launches on the same inputs give the same bits.
//
// Design (gat_common.cuh): one block per destination chunk, the planes the
// slot cover occ names staged in shared memory, warp w owns rows
// 16w..16w+15 and walks each row's nonzero plane words by ballot, lane l
// owns columns l, l+32, ...; per edge the payload's xp and a_src are read
// from global memory and the head dot goes through the warp's shared-memory
// row. Any (h, ch) with h*ch + 2h <= 512.
//
// Plain C interface, loaded with ctypes (kernels/gat_cuda.py).

#include <math.h>

#include "gat_common.cuh"

namespace {

using namespace gat;

template <int CPL>
__global__ void __launch_bounds__(kThreads)
gat_bwd_dst_kernel(const uint8_t* __restrict__ a,          // [B, planes, C, C]
                   const int32_t* __restrict__ src_chunk,  // [B, depth]
                   const int32_t* __restrict__ occ,        // [B] or null
                   const float* __restrict__ g2,           // [B*C, W2]
                   const float* __restrict__ payload,      // [B*C, W]
                   float* __restrict__ ct,                 // [B*C, W]
                   int depth, int planes, int pack, int h, int ch, float slope) {
  extern __shared__ __align__(16) uint32_t planes_sm[];  // n_planes * 16 KB
  __shared__ int32_t src_sm[kMaxDepth];
  __shared__ float red_sm[kWarps][CPL * 32];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hc = h * ch;
  const int width = hc + 2 * h;
  const int width2 = hc + 3 * h;
  const int n_planes = planes_needed(occ, b, depth, pack);
  stage_tables(planes_sm, src_sm, a, src_chunk, b, depth, planes, n_planes);
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
    const int i = warp * kRowsPerWarp + r;
    const size_t row = (size_t)b * kChunk + i;
    const float* own = g2 + row * width2;
    float abar[CPL], sbar[CPL], adst[CPL], m[CPL], dadst[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      abar[k] = live[k] ? __ldg(own + lane + 32 * k) : 0.f;
      sbar[k] = live[k] ? __ldg(own + hc + head[k]) : 0.f;
      adst[k] = live[k] ? __ldg(own + hc + h + head[k]) : 0.f;
      m[k] = live[k] ? __ldg(own + hc + 2 * h + head[k]) : 0.f;
      dadst[k] = 0.f;
    }
    for_each_edge(
        planes_sm, src_sm, n_planes, pack, i, lane,
        [&](int src_row, float mult) {
          const float* p = payload + (size_t)src_row * width;
          float e_sig[CPL], part[CPL], q[CPL];
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            e_sig[k] = part[k] = 0.f;
            if (!live[k]) continue;
            const float t = adst[k] + __ldg(p + hc + head[k]);
            // the forward's m makes the exponent <= 0; the clamp matches
            // the plain closed form
            e_sig[k] = mult * expf(fminf(lrelu(t, slope) - m[k], 0.f)) *
                       (t >= 0.f ? 1.f : slope);
            part[k] = __ldg(p + lane + 32 * k) * abar[k];
          }
          head_sum<CPL>(red, part, q, head, live, lane, ch);
#pragma unroll
          for (int k = 0; k < CPL; ++k)
            if (live[k]) dadst[k] += e_sig[k] * (q[k] + sbar[k]);
        });
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (first[k]) ct[row * width + hc + h + head[k]] = dadst[k];
  }
}

template <int CPL>
cudaError_t launch(const uint8_t* a, const int32_t* src_chunk, const int32_t* occ,
                   const float* g2, const float* payload, float* ct,
                   int num_chunks, int depth, int planes, int pack, int h, int ch,
                   float slope, cudaStream_t stream) {
  const size_t smem = (size_t)planes * kPlaneBytes;
  cudaError_t err = cudaFuncSetAttribute(
      gat_bwd_dst_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gat_bwd_dst_kernel<CPL><<<num_chunks, kThreads, smem, stream>>>(
      a, src_chunk, occ, g2, payload, ct, depth, planes, pack, h, ch, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch. occ may be null.
int gat_bwd_dst_launch(const void* a, const void* src_chunk, const void* occ,
                       const void* g2, const void* payload, void* ct,
                       int num_chunks, int depth, int planes, int pack, int h,
                       int ch, float slope, void* stream) {
  const int hc = h * ch;
  if (num_chunks <= 0 || depth <= 0 || depth > kMaxDepth || h <= 0 || ch <= 0 ||
      hc + 2 * h > kMaxCols || (pack != 1 && pack != 2 && pack != 4) ||
      planes * pack < depth)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const int32_t* sc = static_cast<const int32_t*>(src_chunk);
  const int32_t* oc = static_cast<const int32_t*>(occ);
  const float* g = static_cast<const float*>(g2);
  const float* pay = static_cast<const float*>(payload);
  float* o = static_cast<float*>(ct);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpl = (hc + 31) / 32;
  cudaError_t err;
#define GAT_BWD_DST_CASE(N)                                                     \
  err = launch<N>(a8, sc, oc, g, pay, o, num_chunks, depth, planes, pack, h, ch, \
                  slope, s)
  if (cpl <= 1) GAT_BWD_DST_CASE(1);
  else if (cpl <= 2) GAT_BWD_DST_CASE(2);
  else if (cpl <= 4) GAT_BWD_DST_CASE(4);
  else if (cpl <= 8) GAT_BWD_DST_CASE(8);
  else GAT_BWD_DST_CASE(16);
#undef GAT_BWD_DST_CASE
  return static_cast<int>(err);
}

const char* gat_bwd_dst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
