// Used by gat_bwd_dst.cu alone (the other kernels walk the edge lists of
// bsda_edges.cuh): the block shape, the staging of a chunk's multiplicity
// planes in shared memory, the walk over the edges of one destination row
// (a row of the planes), and the per-head sum over a warp's columns.
//
// Table layout (kernels/bsda.py): a [B, planes, 128, 128] bytes. With
// pack 1 a byte is the int8 multiplicity of slot d = plane; with pack 2 or
// 4 a byte holds `pack` slots of 8 / pack bits each, slot d in plane
// d / pack at bit offset (8 / pack) * (d % pack). a[b, d, i, j] is the
// multiplicity of edge (src_chunk[b, d] * 128 + j) -> (b * 128 + i).
//
// The tables are >99% zeros (about two edges a row at Elliptic scale), so
// the kernel touches only the edges: per row each lane tests one 4-byte
// word of every staged plane, a warp ballot finds the nonzero words, and
// the warp walks those together.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gat {

constexpr int kChunk = 128;                    // BsdaGraph.chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kChunk / kWarps;  // 16
constexpr int kPlaneBytes = kChunk * kChunk;   // 16 KB
constexpr int kPlaneWords = kPlaneBytes / 4;
constexpr int kMaxDepth = 64;                  // src_chunk row staged in shared memory
constexpr int kMaxCols = 512;                  // h * ch + 2 h <= 512

// Planes the block must read: slots at and beyond occ[b] are all zero.
__device__ __forceinline__ int planes_needed(const int32_t* occ, int b,
                                             int depth, int pack) {
  const int slots = occ != nullptr ? min(occ[b], depth) : depth;
  return (slots + pack - 1) / pack;
}

// Stage chunk b's first n_planes planes (contiguous in the table) and its
// src_chunk row. Ends with a block barrier.
__device__ __forceinline__ void stage_tables(uint32_t* planes_sm, int32_t* src_sm,
                                             const uint8_t* a,
                                             const int32_t* src_chunk, int b,
                                             int depth, int planes, int n_planes) {
  const uint4* src4 = reinterpret_cast<const uint4*>(
      a + (size_t)b * planes * (size_t)kPlaneBytes);
  uint4* dst4 = reinterpret_cast<uint4*>(planes_sm);
  for (int q = threadIdx.x; q < n_planes * (kPlaneBytes / 16); q += kThreads)
    dst4[q] = __ldg(src4 + q);
  if (threadIdx.x < depth) src_sm[threadIdx.x] = src_chunk[b * depth + threadIdx.x];
  __syncthreads();
}

// Calls f(src_row, mult) for every edge into row i of the chunk, in
// increasing (plane, j, slot) order. The whole warp calls this together
// and every lane sees every edge, so f may use warp-level primitives.
template <typename F>
__device__ __forceinline__ void for_each_edge(const uint32_t* planes_sm,
                                              const int32_t* src_sm, int n_planes,
                                              int pack, int i, int lane, F&& f) {
  const int bits = 8 / pack;
  const uint32_t mask = (1u << bits) - 1u;
  for (int p = 0; p < n_planes; ++p) {
    const uint32_t word = planes_sm[p * kPlaneWords + i * (kChunk / 4) + lane];
    uint32_t nz = __ballot_sync(0xffffffffu, word != 0u);
    while (nz != 0u) {
      const int k = __ffs(nz) - 1;
      nz &= nz - 1u;
      const uint32_t w = __shfl_sync(0xffffffffu, word, k);
      for (int by = 0; by < 4; ++by) {
        const uint32_t byte = (w >> (8 * by)) & 0xffu;
        if (byte == 0u) continue;
        const int j = 4 * k + by;
        for (int sl = 0; sl < pack; ++sl) {
          const uint32_t m = (byte >> (bits * sl)) & mask;
          if (m != 0u) f(src_sm[p * pack + sl] * kChunk + j, static_cast<float>(m));
        }
      }
    }
  }
}

__device__ __forceinline__ float lrelu(float t, float slope) {
  return t >= 0.f ? t : t * slope;
}

// sum[k] = sum of part[] over the columns of column k's head, through the
// warp's shared-memory row `red` (CPL * 32 floats), always in column order.
// Lane l owns columns l, l + 32, ... (CPL of them, `live` where below h * ch)
// and column c belongs to head[k] = c / ch. All lanes of the warp call this
// together.
template <int CPL>
__device__ __forceinline__ void head_sum(float* red, const float (&part)[CPL],
                                         float (&sum)[CPL], const int (&head)[CPL],
                                         const bool (&live)[CPL], int lane, int ch) {
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (live[k]) red[lane + 32 * k] = part[k];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    float v = 0.f;
    if (live[k])
      for (int x = head[k] * ch; x < (head[k] + 1) * ch; ++x) v += red[x];
    sum[k] = v;
  }
  __syncwarp();
}

}  // namespace gat
