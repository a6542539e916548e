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
//      payload [B*128, W] the forward's input [ xp | a_src | a_dst ],
//      out_k   [B*128, W] the forward's output: its m columns give the
//              same m, and so the same e, as the forward; with
//              `normalized` its acc columns hold val = acc / s and gbar is
//              the cotangent of (val, s), turned into (A, S) per row in
//              registers: A = gbar / s, S = gbar_s - (gbar . val) / s,
//              with 1 / max(s, 1e-16).
// out: ct [B*128, W] rows [ d xp | d a_src | d a_dst ], zeroed by the
//      caller before the launch.
//
// Replaces elliptic_gnn_tpu/kernels/pallas_gat_bwd.py::_sweep_fused_call
// together with the assembly in ::flash_gat_backward3: the z1/z2 rows, the
// transpose and the xp . z2 contraction there are how the TPU kernel got
// around its layout, not part of the function.
//
// What bounds it: bytes (planes, three [N, W] inputs read once, one output
// written once); per edge it does 3 h ch multiply-adds and h exps.
//
// The TPU kernel keeps the per-source sums in a revolving VMEM accumulator
// because its grid runs in order. Blocks here run in any order, so d xp_j
// and d a_src_j, which gather over rows of other blocks, are added with
// f32 atomicAdd into the zeroed output: a warp's adds for one edge fall on
// consecutive addresses of one source row. Their order, and so the last
// bits of those columns, changes from run to run. d a_dst_i is a sum over
// the row's own edges: registers, one plain store, deterministic.
//
// Design: as gat_fwd.cu (one block per destination chunk, warp per row,
// lane l owns columns l, l+32, ...). The two dot products over a head's
// ch columns (gbar . val per row, xp_j . A_i per edge) go through a
// per-warp shared-memory row (gat_common.cuh head_sum): every column writes
// its product, then sums its head's ch entries. Any (h, ch) with h*ch + 2h <= 512.
//
// Plain C interface, loaded with ctypes (kernels/gat_cuda.py).

#include <math.h>

#include "gat_common.cuh"

namespace {

using namespace gat;

template <int CPL>
__global__ void __launch_bounds__(kThreads)
gat_bwd_kernel(const uint8_t* __restrict__ a,          // [B, planes, C, C]
               const int32_t* __restrict__ src_chunk,  // [B, depth]
               const int32_t* __restrict__ occ,        // [B] or null
               const float* __restrict__ gbar,         // [B*C, W]
               const float* __restrict__ payload,      // [B*C, W]
               const float* __restrict__ out_k,        // [B*C, W]
               float* __restrict__ ct,                 // [B*C, W], zeroed
               int depth, int planes, int pack, int h, int ch, float slope,
               int normalized) {
  extern __shared__ __align__(16) uint32_t planes_sm[];  // n_planes * 16 KB
  __shared__ int32_t src_sm[kMaxDepth];
  __shared__ float red_sm[kWarps][CPL * 32];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hc = h * ch;
  const int width = hc + 2 * h;
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
    const size_t base = ((size_t)b * kChunk + i) * width;
    float adst[CPL], m[CPL], abar[CPL], sbar[CPL], dadst[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      adst[k] = live[k] ? __ldg(payload + base + hc + h + head[k]) : 0.f;
      m[k] = live[k] ? __ldg(out_k + base + hc + head[k]) : 0.f;
      abar[k] = live[k] ? __ldg(gbar + base + lane + 32 * k) : 0.f;
      sbar[k] = live[k] ? __ldg(gbar + base + hc + h + head[k]) : 0.f;
      dadst[k] = 0.f;
    }
    if (normalized) {
      float part[CPL], dot[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        part[k] = live[k] ? abar[k] * __ldg(out_k + base + lane + 32 * k) : 0.f;
      head_sum<CPL>(red, part, dot, head, live, lane, ch);
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (!live[k]) continue;
        const float inv_s =
            1.f / fmaxf(__ldg(out_k + base + hc + h + head[k]), 1e-16f);
        abar[k] *= inv_s;
        sbar[k] -= dot[k] * inv_s;
      }
    }
    for_each_edge(
        planes_sm, src_sm, n_planes, pack, i, lane,
        [&](int src_row, float mult) {
          const float* p = payload + (size_t)src_row * width;
          float* o = ct + (size_t)src_row * width;
          float e[CPL], gate[CPL], part[CPL], q[CPL];
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            e[k] = gate[k] = part[k] = 0.f;
            if (!live[k]) continue;
            const float t = adst[k] + __ldg(p + hc + head[k]);
            // the forward's m makes the exponent <= 0; the clamp matches
            // the plain closed form
            e[k] = mult * expf(fminf(lrelu(t, slope) - m[k], 0.f));
            gate[k] = t >= 0.f ? 1.f : slope;
            part[k] = __ldg(p + lane + 32 * k) * abar[k];
          }
          head_sum<CPL>(red, part, q, head, live, lane, ch);
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            if (!live[k]) continue;
            const float dt = e[k] * gate[k] * (q[k] + sbar[k]);
            dadst[k] += dt;
            atomicAdd(o + lane + 32 * k, e[k] * abar[k]);
            if (first[k]) atomicAdd(o + hc + head[k], dt);
          }
        });
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (first[k]) ct[base + hc + h + head[k]] = dadst[k];
  }
}

template <int CPL>
cudaError_t launch(const uint8_t* a, const int32_t* src_chunk, const int32_t* occ,
                   const float* gbar, const float* payload, const float* out_k,
                   float* ct, int num_chunks, int depth, int planes, int pack,
                   int h, int ch, float slope, int normalized,
                   cudaStream_t stream) {
  const size_t smem = (size_t)planes * kPlaneBytes;
  cudaError_t err = cudaFuncSetAttribute(
      gat_bwd_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gat_bwd_kernel<CPL><<<num_chunks, kThreads, smem, stream>>>(
      a, src_chunk, occ, gbar, payload, out_k, ct, depth, planes, pack, h, ch,
      slope, normalized);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch. occ may be null; ct must be zero.
int gat_bwd_launch(const void* a, const void* src_chunk, const void* occ,
                   const void* gbar, const void* payload, const void* out_k,
                   void* ct, int num_chunks, int depth, int planes, int pack,
                   int h, int ch, float slope, int normalized, void* stream) {
  const int hc = h * ch;
  if (num_chunks <= 0 || depth <= 0 || depth > kMaxDepth || h <= 0 || ch <= 0 ||
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
  const int cpl = (hc + 31) / 32;
  cudaError_t err;
#define GAT_BWD_CASE(N)                                                      \
  err = launch<N>(a8, sc, oc, gb, pay, ok, o, num_chunks, depth, planes, pack, \
                  h, ch, slope, normalized, s)
  if (cpl <= 1) GAT_BWD_CASE(1);
  else if (cpl <= 2) GAT_BWD_CASE(2);
  else if (cpl <= 4) GAT_BWD_CASE(4);
  else if (cpl <= 8) GAT_BWD_CASE(8);
  else GAT_BWD_CASE(16);
#undef GAT_BWD_CASE
  return static_cast<int>(err);
}

const char* gat_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
