// ELL SpMM for Hopper (sm_90a): the aggregation of an ELL encoding in its
// flat form (kernels/ell.py::EllTables),
//
//     out[d] = scale[d] * sum_{e in row_ptr[d] .. row_ptr[d+1]} w[e] * x[col[e]]
//
// in f32, for any feature width F. Its gradient is the same kernel on the
// transpose tables (A^T, weights w[e] * scale[dst], no scale).
//
// Replaces no Pallas kernel: the JAX package ran its ELL path as plain XLA
// gathers and a weighted sum per degree bucket, and the port ran them as
// ATen ops (index_select writing a [rows, width, F] copy of every
// neighbour row, padding slots included, a GEMV reading it back, a scale
// pass, a cat of the buckets, and an index_add_ with atomics backward).
// This kernel computes the same function in one launch, from the rows of
// x to the rows of out, with no intermediate in device memory.
//
// What bounds it: bytes. Elliptic's graph has about two edges a row, so
// each output row takes one multiply-add a column and edge against F * 4
// bytes of x gathered and F * 4 bytes written: x read once and out written
// once at 3.35 TB/s is the least time (32 us at F = 64 and 83 us at
// F = 168 over 203,769 rows). The gathers are random rows, so what limits
// the kernel is how many row loads are in flight, not the arithmetic.
//
// Design: a group of lanes owns a destination row, sized from F: each lane
// loads VEC adjacent floats at once (16 bytes where F and the pointers
// allow), the group spans the row (F = 64: 16 lanes, two rows a warp;
// F = 168: a full warp, each lane two vectors, the second only on ten
// lanes) and a lane holds C vectors of it. The group walks its row's edges
// U at a time: U column indices and weights, then every lane's U * C
// vectors of x issued together, then summed in edge order (fixed: two runs
// give the same bits; padding slots are not in the tables, so never read).
// A row of more than long_degree edges (Elliptic's hubs, up to hundreds)
// would hold its group for as many dependent loads: each takes a block of
// its own instead, the first blocks of the launch, whose groups sum every
// G-th edge and add their G partial rows in group order through shared
// memory. The other blocks take the rows from the last on: after
// renumber_for_ell rows lie in order of degree bucket, so a warp's rows
// have similar degrees and the widest start first, the one-edge rows
// last. x is read through the read-only path (an L2 evict-last hint on it
// measured no faster, cold or warm), out written with streaming stores.
// 256 threads a block, many blocks an SM.
//
// Plain C interface, loaded with ctypes (kernels/ell_spmm_cuda.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // edges whose x rows a lane loads at once

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ void to(const T& v, float (&a)[4]) {
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  }
  static __device__ __forceinline__ T from(const float (&a)[4]) {
    return make_float4(a[0], a[1], a[2], a[3]);
  }
};

template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ void to(const T& v, float (&a)[2]) {
    a[0] = v.x; a[1] = v.y;
  }
  static __device__ __forceinline__ T from(const float (&a)[2]) {
    return make_float2(a[0], a[1]);
  }
};

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void to(const T& v, float (&a)[1]) { a[0] = v; }
  static __device__ __forceinline__ T from(const float (&a)[1]) { return a[0]; }
};

// The flat tables (kernels/ell.py::EllTables) as the launch passes them.
struct Tables {
  const int32_t* row_ptr;    // [n_rows + 1]
  const int32_t* col;        // [nnz] rows of x
  const float* w;            // [nnz]
  const float* scale;        // [n_rows], or null: ones
  const int32_t* long_rows;  // [n_long] the rows of more than long_degree edges
  int n_long, long_degree, n_rows;
};

// Adds the edges e0, e0 + step, ... below e1, in that order, to a lane's C
// vectors of the row's columns (vector j = base + c * lanes).
template <int VEC, int C>
__device__ __forceinline__ void sum_edges(const Tables& t, const float* __restrict__ x,
                                          int f, int nvec, int base, int lanes, int e0,
                                          int e1, int step, float (&acc)[C][VEC]) {
  using V = Vec<VEC>;
  using VT = typename V::T;
  for (; e0 < e1; e0 += kUnroll * step) {
    const int n = min(kUnroll, (e1 - e0 + step - 1) / step);
    int src[kUnroll];
    float wt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      src[u] = u < n ? __ldg(t.col + e0 + u * step) : 0;
      wt[u] = u < n ? __ldg(t.w + e0 + u * step) : 0.0f;
    }
    VT v[kUnroll][C];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const VT* xr = reinterpret_cast<const VT*>(x + (int64_t)src[u] * f);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = base + c * lanes;
        v[u][c] = VT{};
        if (u < n && j < nvec) v[u][c] = __ldg(xr + j);
      }
    }
    // edge order: the sum is the same bits in every run
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < n) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float a[VEC];
          V::to(v[u][c], a);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[c][k] = fmaf(wt[u], a[k], acc[c][k]);
        }
      }
    }
  }
}

// One launch. The first n_long blocks take a long row each: each of the
// block's G groups sums every G-th edge into shared memory, and the block
// adds the G partial rows in group order. The other blocks give each group
// a row and skip the long rows. `lanes_log2`: the group's lanes (a power
// of two up to 32); VEC floats a load, C vectors a lane in a pass over the
// row's columns (a row wider than lanes * C * VEC takes several passes).
template <int VEC, int C>
__global__ void __launch_bounds__(kThreads)
    ell_spmm_kernel(const Tables t, const float* __restrict__ x, float* __restrict__ out,
                    int f, int lanes_log2) {
  using V = Vec<VEC>;
  using VT = typename V::T;
  constexpr int kPass = C * VEC;  // floats a lane holds in a pass
  __shared__ float part[kThreads * kPass];
  const int lanes = 1 << lanes_log2;
  const int groups = kThreads >> lanes_log2;
  const int gi = threadIdx.x >> lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int nvec = f / VEC;

  if ((int)blockIdx.x < t.n_long) {
    const int64_t row = __ldg(t.long_rows + blockIdx.x);
    const int beg = __ldg(t.row_ptr + row);
    const int end = __ldg(t.row_ptr + row + 1);
    const float s = t.scale != nullptr ? __ldg(t.scale + row) : 1.0f;
    for (int pass = 0; pass < nvec; pass += lanes * C) {  // in vectors
      float acc[C][VEC] = {};
      sum_edges<VEC, C>(t, x, f, nvec, pass + lane, lanes, beg + gi, end, groups, acc);
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          part[gi * lanes * kPass + (c * lanes + lane) * VEC + k] = acc[c][k];
      __syncthreads();
      const int width = min(lanes * kPass, f - pass * VEC);
      for (int q = threadIdx.x; q < width; q += kThreads) {
        float sum = 0.0f;
        for (int g = 0; g < groups; ++g) sum += part[g * lanes * kPass + q];
        __stcs(out + row * f + pass * VEC + q, sum * s);
      }
      __syncthreads();
    }
    return;
  }

  // the last rows first: after renumber_for_ell they are the widest
  // buckets', whose walks would otherwise trail the launch
  const int64_t row = (int64_t)(gridDim.x - 1 - blockIdx.x) * groups + gi;
  if (row >= t.n_rows) return;
  const int beg = __ldg(t.row_ptr + row);
  const int end = __ldg(t.row_ptr + row + 1);
  if (end - beg > t.long_degree) return;  // a block of its own has it
  const float s = t.scale != nullptr ? __ldg(t.scale + row) : 1.0f;
  VT* out_row = reinterpret_cast<VT*>(out + row * f);
  for (int base = lane; base < nvec; base += lanes * C) {
    float acc[C][VEC] = {};
    sum_edges<VEC, C>(t, x, f, nvec, base, lanes, beg, end, 1, acc);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = base + c * lanes;
      if (j < nvec) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[c][k] *= s;
        __stcs(out_row + j, V::from(acc[c]));
      }
    }
  }
}

template <int VEC, int C>
cudaError_t launch(const Tables& t, const float* x, float* out, int f, int lanes_log2,
                   cudaStream_t stream) {
  const int rows_per_block = kThreads >> lanes_log2;
  const unsigned blocks =
      (unsigned)t.n_long + (unsigned)((t.n_rows + rows_per_block - 1) / rows_per_block);
  ell_spmm_kernel<VEC, C><<<blocks, kThreads, 0, stream>>>(t, x, out, f, lanes_log2);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_vec(const Tables& t, const float* x, float* out, int f,
                       cudaStream_t stream) {
  // the group: enough lanes for the row's vectors, at most a warp; past a
  // warp each lane holds C vectors (2 for F = 168, 4 from 65 vectors on)
  const int nvec = f / VEC;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < nvec && lanes_log2 < 5) ++lanes_log2;
  const int per_lane = (nvec + 31) / 32;
  if (per_lane <= 1) return launch<VEC, 1>(t, x, out, f, lanes_log2, stream);
  if (per_lane == 2) return launch<VEC, 2>(t, x, out, f, lanes_log2, stream);
  return launch<VEC, 4>(t, x, out, f, lanes_log2, stream);
}

}  // namespace

extern "C" {

// out [n_rows, f] f32 from x [*, f] f32 through the flat tables: row_ptr
// [n_rows + 1] and col [nnz] int32, w [nnz] f32, scale [n_rows] f32 or
// null (ones), long_rows [n_long] int32: every row of more than
// long_degree edges. Returns the cudaError_t of the launch.
int ell_spmm_launch(const void* row_ptr, const void* col, const void* w, const void* scale,
                    const void* long_rows, int n_long, int long_degree, const void* x,
                    void* out, int n_rows, int f, void* stream) {
  if (n_rows <= 0 || f <= 0 || n_long < 0 || n_long > n_rows || long_degree < 0 ||
      (n_long > 0 && long_rows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t = {static_cast<const int32_t*>(row_ptr),
                    static_cast<const int32_t*>(col),
                    static_cast<const float*>(w),
                    static_cast<const float*>(scale),
                    static_cast<const int32_t*>(long_rows),
                    n_long,
                    long_degree,
                    n_rows};
  const auto xf = static_cast<const float*>(x);
  const auto of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t both = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  cudaError_t err;
  if (f % 4 == 0 && both % 16 == 0)
    err = launch_vec<4>(t, xf, of, f, s);
  else if (f % 2 == 0 && both % 8 == 0)
    err = launch_vec<2>(t, xf, of, f, s);
  else
    err = launch_vec<1>(t, xf, of, f, s);
  return static_cast<int>(err);
}

const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
