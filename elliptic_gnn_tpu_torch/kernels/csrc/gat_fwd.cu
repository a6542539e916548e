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
//   separable exp to spare the VPU. Here only the edges are walked
//   (gat_common.cuh) and exp(lrelu(t) - m) is computed per edge.
// - The softmax shift. The TPU kernels take m = lrelu(a_dst_i + max a_src)
//   over all 128 rows of each source chunk, neighbours or not: an upper
//   bound that lets every true edge underflow when a_src spreads widely
//   inside a chunk. Walking edges gives the exact max over the row's own
//   edges (pass 1), so e <= mult and the largest term is exactly mult.
//   Everything downstream is invariant to the shift: compare acc / s and
//   m + log s with another gauge, never m or s alone.
// - No grid order, no DMA ring, no 128-lane padding of the payload: each
//   block reads the source rows it needs through L2, where the band
//   (|chunk(i) - chunk(j)| small) keeps them.
//
// Rows with no dense edge (padding, occ 0, all edges spilled) write
// s = 0, acc = 0 and m = -1e30, finite so that the spill merge's
// exp(m1 - max(m1, m2)) is never inf - inf.
//
// Design: one block per destination chunk, 8 warps, warp w owns rows
// 16w..16w+15 one after another. Lane l owns output columns l, l+32, ...
// (CPL of them); a column c belongs to head c / ch and keeps its head's
// m and s itself, so no lane ever needs another's value. Per row: pass 1
// takes the max of a_src over the edges (lrelu is monotonic), pass 2
// accumulates s and acc in registers in edge order, so the sums are
// deterministic. f32 throughout.
//
// Plain C interface, loaded with ctypes (kernels/gat_cuda.py).

#include <math.h>

#include "gat_common.cuh"

namespace {

using namespace gat;

template <int CPL>
__global__ void __launch_bounds__(kThreads)
gat_fwd_kernel(const uint8_t* __restrict__ a,          // [B, planes, C, C]
               const int32_t* __restrict__ src_chunk,  // [B, depth]
               const int32_t* __restrict__ occ,        // [B] or null
               const float* __restrict__ payload,      // [B*C, W]
               float* __restrict__ out,                // [B*C, W]
               int depth, int planes, int pack, int h, int ch, float slope,
               int normalize) {
  extern __shared__ __align__(16) uint32_t planes_sm[];  // n_planes * 16 KB
  __shared__ int32_t src_sm[kMaxDepth];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hc = h * ch;
  const int width = hc + 2 * h;
  const int n_planes = planes_needed(occ, b, depth, pack);
  stage_tables(planes_sm, src_sm, a, src_chunk, b, depth, planes, n_planes);

  int head[CPL];
  bool live[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    live[k] = c < hc;
    head[k] = live[k] ? c / ch : 0;
  }

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = warp * kRowsPerWarp + r;
    const size_t row = (size_t)b * kChunk + i;
    float adst[CPL], mx[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      adst[k] = live[k] ? __ldg(payload + row * width + hc + h + head[k]) : 0.f;
      mx[k] = -INFINITY;
    }
    for_each_edge(planes_sm, src_sm, n_planes, pack, i, lane,
                  [&](int src_row, float) {
                    const float* p = payload + (size_t)src_row * width + hc;
#pragma unroll
                    for (int k = 0; k < CPL; ++k)
                      if (live[k]) mx[k] = fmaxf(mx[k], __ldg(p + head[k]));
                  });
    float m[CPL], s[CPL], acc[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      m[k] = mx[k] > -INFINITY ? lrelu(adst[k] + mx[k], slope) : kNegInf;
      s[k] = 0.f;
      acc[k] = 0.f;
    }
    for_each_edge(planes_sm, src_sm, n_planes, pack, i, lane,
                  [&](int src_row, float mult) {
                    const float* p = payload + (size_t)src_row * width;
#pragma unroll
                    for (int k = 0; k < CPL; ++k) {
                      if (!live[k]) continue;
                      const float t = adst[k] + __ldg(p + hc + head[k]);
                      const float e = mult * expf(lrelu(t, slope) - m[k]);
                      s[k] += e;
                      acc[k] += e * __ldg(p + lane + 32 * k);
                    }
                  });
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (!live[k]) continue;
      const int c = lane + 32 * k;
      out[row * width + c] = normalize ? acc[k] / fmaxf(s[k], 1e-16f) : acc[k];
      if (c == head[k] * ch) {  // the head's first column writes its m and s
        out[row * width + hc + head[k]] = m[k];
        out[row * width + hc + h + head[k]] = s[k];
      }
    }
  }
}

template <int CPL>
cudaError_t launch(const uint8_t* a, const int32_t* src_chunk, const int32_t* occ,
                   const float* payload, float* out, int num_chunks, int depth,
                   int planes, int pack, int h, int ch, float slope,
                   int normalize, cudaStream_t stream) {
  const size_t smem = (size_t)planes * kPlaneBytes;
  cudaError_t err = cudaFuncSetAttribute(
      gat_fwd_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gat_fwd_kernel<CPL><<<num_chunks, kThreads, smem, stream>>>(
      a, src_chunk, occ, payload, out, depth, planes, pack, h, ch, slope,
      normalize);
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
  if (num_chunks <= 0 || depth <= 0 || depth > kMaxDepth || h <= 0 || ch <= 0 ||
      hc + 2 * h > kMaxCols || (pack != 1 && pack != 2 && pack != 4) ||
      planes * pack < depth)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const int32_t* sc = static_cast<const int32_t*>(src_chunk);
  const int32_t* oc = static_cast<const int32_t*>(occ);
  const float* pay = static_cast<const float*>(payload);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpl = (hc + 31) / 32;
  cudaError_t err;
#define GAT_FWD_CASE(N)                                                       \
  err = launch<N>(a8, sc, oc, pay, o, num_chunks, depth, planes, pack, h, ch, \
                  slope, normalize, s)
  if (cpl <= 1) GAT_FWD_CASE(1);
  else if (cpl <= 2) GAT_FWD_CASE(2);
  else if (cpl <= 4) GAT_FWD_CASE(4);
  else if (cpl <= 8) GAT_FWD_CASE(8);
  else GAT_FWD_CASE(16);
#undef GAT_FWD_CASE
  return static_cast<int>(err);
}

const char* gat_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
