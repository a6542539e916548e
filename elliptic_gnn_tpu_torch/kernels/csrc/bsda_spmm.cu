// BSDA SpMM for Hopper (sm_90a): the dense part of the banded block-sparse
// aggregation,
//
//     out[b] = ds[b] * sum_d unpack(A)[b, d] @ (ss * x)[src_chunk[b, d]]
//
// over 128 x 128 blocks, for any feature width F.
//
// Replaces elliptic_gnn_tpu/kernels/pallas_bsda.py::_ring_call (one feature
// tile) and ::_banded_call (several tiles), whose shared inner loop is
// _slot_compute (pallas_bsda.py:77-117). The TPU kernels stream x through a
// VMEM ring or window because their grid runs in order on one core; here
// blocks run in parallel and each stages what it needs itself.
//
// What bounds it: bytes. The A table holds ~0.6% nonzeros at Elliptic scale
// (about 2.3 edges a row), so the dense 128x128 products the TPU's MXU runs
// would be ~99% multiplies by zero on CUDA cores. This kernel does a
// multiply-add only per edge: the work is the A bytes plus one staged x
// tile per slot, and the arithmetic is negligible.
//
// Design: one block per (destination chunk b, 64-column feature tile);
// 8 warps, warp w owns rows 16w..16w+15 and lane l owns columns l and l+32
// of the tile, accumulating in f32 registers. The block stages the A
// bit-plane it needs (16 KB, coalesced 16-byte loads) in shared memory.
// Per slot d it stages the source chunk's [128, 64] tile of (ss * x),
// rounded to x's type exactly as the TPU kernel rounds its rhs, with
// 16-byte loads where the row stride allows. Then per row each lane reads
// one 4-byte word of the row's plane bytes, a warp ballot finds the words
// holding an edge of slot d, and the warp walks only those (a shuffle
// broadcasts each word): per edge with multiplicity m at column j, every
// lane adds m * tile[j][col]. Edges of a row are taken in increasing j, so
// the f32 sums are deterministic. The epilogue multiplies by ds in f32 and
// rounds to x's type.
//
// Numerics match the TPU kernel: with bf16 x the staged value is
// bf16(bf16(x) * bf16(ss)); products of small integer multiplicities with
// bf16 values are exact in f32; ds scales the f32 sum; the store rounds to
// bf16. Only the order of the f32 additions differs.
//
// Plain C interface, loaded with ctypes (kernels/bsda_spmm_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;              // BsdaGraph.chunk
constexpr int kTile = 64;                // feature columns per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kChunk / kWarps;  // 16
constexpr int kColsPerLane = kTile / 32;       // 2
constexpr int kPlaneBytes = kChunk * kChunk;   // 16 KB

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  // 16 bytes = 4 values
  static __device__ __forceinline__ void load16(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // 16 bytes = 8 values
  static __device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

// tile[j][c] = round(round(x[src*C + j, f0 + c]) * round(ss[src*C + j])),
// zero outside [n_rows, f)
template <typename T>
__device__ __forceinline__ void stage_tile(float (*tile)[kTile], const T* x,
                                           const float* ss, int src, int f0,
                                           int n_rows, int f, bool vec16) {
  if (vec16) {  // f * sizeof(T) is a multiple of 16: whole vectors in or out
    constexpr int V = 16 / sizeof(T);
    constexpr int kVecsPerRow = kTile / V;
    for (int idx = threadIdx.x; idx < kChunk * kVecsPerRow; idx += kThreads) {
      const int j = idx / kVecsPerRow;
      const int c = (idx % kVecsPerRow) * V;
      const int row = src * kChunk + j;
      const int col = f0 + c;
      float v[V];
      if (row < n_rows && col < f) {
        Io<T>::load16(x + (size_t)row * f + col, v);
        if (ss != nullptr) {
          const float s = Io<T>::round(ss[row]);
#pragma unroll
          for (int k = 0; k < V; ++k) v[k] = Io<T>::round(v[k] * s);
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < V; k += 4)
        *reinterpret_cast<float4*>(&tile[j][c + k]) =
            make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kChunk * kTile; idx += kThreads) {
    const int j = idx / kTile;
    const int c = idx % kTile;
    const int row = src * kChunk + j;
    const int col = f0 + c;
    float v = 0.f;
    if (row < n_rows && col < f) {
      v = Io<T>::load(x + (size_t)row * f + col);
      if (ss != nullptr) v = Io<T>::round(v * Io<T>::round(ss[row]));
    }
    tile[j][c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsda_spmm_kernel(const uint8_t* __restrict__ a,          // [B, planes, C, C]
                 const int32_t* __restrict__ src_chunk,  // [B, depth]
                 const T* __restrict__ x,                // [n_rows, f]
                 const float* __restrict__ ds,           // [B*C] or null
                 const float* __restrict__ ss,           // [B*C] or null
                 T* __restrict__ out,                    // [n_rows, f]
                 int depth, int planes, int pack, int n_rows, int f,
                 int vec16) {
  __shared__ __align__(16) float tile[kChunk][kTile];       // 32 KB
  __shared__ __align__(16) uint32_t plane[kPlaneBytes / 4];  // 16 KB

  const int b = blockIdx.x;
  const int f0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bits = 8 / pack;
  const uint32_t mask = (1u << bits) - 1u;

  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.f;

  int staged_plane = -1;
  for (int d = 0; d < depth; ++d) {
    const int p = d / pack;
    if (p != staged_plane) {
      const uint4* src4 = reinterpret_cast<const uint4*>(
          a + ((size_t)b * planes + p) * (size_t)kPlaneBytes);
      uint4* dst4 = reinterpret_cast<uint4*>(plane);
      for (int q = threadIdx.x; q < kPlaneBytes / 16; q += kThreads)
        dst4[q] = __ldg(src4 + q);
      staged_plane = p;
    }
    stage_tile<T>(tile, x, ss, src_chunk[b * depth + d], f0, n_rows, f,
                  vec16 != 0);
    __syncthreads();

    const int shift = bits * (d % pack);
    const uint32_t word_mask = (mask << shift) * 0x01010101u;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp * kRowsPerWarp + r;
      const uint32_t word = plane[i * (kChunk / 4) + lane] & word_mask;
      uint32_t nz = __ballot_sync(0xffffffffu, word != 0u);
      while (nz != 0u) {
        const int k = __ffs(nz) - 1;
        nz &= nz - 1u;
        const uint32_t w = __shfl_sync(0xffffffffu, word, k);
#pragma unroll
        for (int by = 0; by < 4; ++by) {
          const uint32_t m = (w >> (8 * by + shift)) & mask;
          if (m == 0u) continue;
          const int j = 4 * k + by;
          const float mf = static_cast<float>(m);
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c)
            acc[r][c] += mf * tile[j][lane + 32 * c];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = b * kChunk + warp * kRowsPerWarp + r;
    if (row >= n_rows) continue;
    const float scale = ds != nullptr ? ds[row] : 1.f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = f0 + lane + 32 * c;
      if (col >= f) continue;
      const float v = ds != nullptr ? acc[r][c] * scale : acc[r][c];
      Io<T>::store(out + (size_t)row * f + col, v);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int bsda_spmm_launch(const void* a, const void* src_chunk, const void* x,
                     const void* ds, const void* ss, void* out,
                     int num_chunks, int depth, int planes, int pack,
                     int n_rows, int f, int dtype, void* stream) {
  const dim3 grid(num_chunks, (f + kTile - 1) / kTile);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const int32_t* sc = static_cast<const int32_t*>(src_chunk);
  const float* dsf = static_cast<const float*>(ds);
  const float* ssf = static_cast<const float*>(ss);
  const int itemsize = dtype == 0 ? 4 : 2;
  // 16-byte loads need 16-byte-aligned rows; x's base comes from the
  // caching allocator (256-byte aligned)
  const int vec16 = ((size_t)f * itemsize) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (dtype == 0) {
    bsda_spmm_kernel<float><<<grid, block, 0, s>>>(
        a8, sc, static_cast<const float*>(x), dsf, ssf,
        static_cast<float*>(out), depth, planes, pack, n_rows, f, vec16);
  } else if (dtype == 1) {
    bsda_spmm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        a8, sc, static_cast<const __nv_bfloat16*>(x), dsf, ssf,
        static_cast<__nv_bfloat16*>(out), depth, planes, pack, n_rows, f,
        vec16);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bsda_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
