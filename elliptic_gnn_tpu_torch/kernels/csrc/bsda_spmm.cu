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
// VMEM ring or window because their grid runs in order on one core, and run
// dense 128 x 128 products on the MXU.
//
// What bounds it: bytes. The A table holds ~0.6% nonzeros at Elliptic scale
// (about 2.3 edges a row), so the work is the plane bytes, one x row
// segment per edge (through L2, where the band keeps them) and the output;
// the arithmetic is one multiply-add per edge and column.
//
// Design (bsda_edges.cuh): one block per destination chunk, for all
// feature tiles. The block lists the chunk's edges once (source row and
// multiplicity in a word, per-row offsets), then per 256-column tile and
// batch of edges fetches every edge's x segment, in x's type, into shared
// memory with cp.async, all copies of a batch in flight at once and the
// next batch's in flight while this one is summed. A thread group owns a
// row and a thread eight adjacent columns of the tile: it sums the row's
// edges from shared memory in list order (slot, then j: deterministic),
// scales by ds (fetched into shared memory at the start) in f32 and stores
// in x's type. A narrow F takes narrow segments and small groups (F = 2:
// one thread a row, F = 64: four rows a warp), not a whole tile's cost.
//
// Numerics match the TPU kernel: with bf16 x the summed value is
// bf16(bf16(x) * bf16(ss)); products of small integer multiplicities with
// bf16 values are exact in f32; ds scales the f32 sum; the store rounds to
// bf16. Only the order of the f32 additions differs.
//
// A rectangular launch (bsda_spmm_launch_rect) runs a slice of the
// destination chunks and writes their rows alone, reading every row of x:
// one rank's rows under the GSPMD row sharding (parallel/gspmd_step.py),
// x all-gathered. The whole-graph launch is the case n_out = n_rows.
//
// Plain C interface, loaded with ctypes (kernels/bsda_spmm_cuda.py).

#include <cuda_bf16.h>

#include "bsda_edges.cuh"

namespace {

using namespace bsda;

constexpr int kTile = 256;  // feature columns per gather
constexpr int kCols = 8;    // adjacent columns a thread owns

template <typename T>
struct Io;

template <>
struct Io<float> {
  // kCols values at p (`odd`: never, f32 rows are 4-byte aligned), times
  // the src scale s where `scaled`
  static __device__ __forceinline__ void load(const unsigned char* p, int, bool scaled,
                                              float s, float (&v)[kCols]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    const float4 r = *reinterpret_cast<const float4*>(p + 16);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    v[4] = r.x; v[5] = r.y; v[6] = r.z; v[7] = r.w;
    if (scaled) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) v[k] *= s;
    }
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  // whole vectors need 16-byte-aligned rows
  static __device__ __forceinline__ bool can_store_all(const float* out, int f) {
    return f % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  }
  static __device__ __forceinline__ void store_all(float* p, const float (&v)[kCols]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  // kCols values that begin 2 * odd bytes after p (gather_rows_shifted),
  // each times bf16(s) and rounded to bf16 where `scaled`: one packed
  // multiply per pair, the same value as bf16(x * bf16(s)) through f32
  static __device__ __forceinline__ void load(const unsigned char* p, int odd,
                                              bool scaled, float s, float (&v)[kCols]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    uint32_t w[4] = {q.x, q.y, q.z, q.w};
    if (odd) {
      const uint32_t next = *reinterpret_cast<const uint32_t*>(p + 16);
      w[0] = __funnelshift_r(w[0], w[1], 16);
      w[1] = __funnelshift_r(w[1], w[2], 16);
      w[2] = __funnelshift_r(w[2], w[3], 16);
      w[3] = __funnelshift_r(w[3], next, 16);
    }
    if (scaled) {
      const __nv_bfloat162 s2 = __float2bfloat162_rn(s);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 y = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]), s2);
        w[k] = *reinterpret_cast<const uint32_t*>(&y);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ bool can_store_all(const __nv_bfloat16* out, int f) {
    return f % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  }
  static __device__ __forceinline__ void store_all(__nv_bfloat16* p,
                                                   const float (&v)[kCols]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// What the launch fixes for every block. n_rows: the rows of x (and ss)
// that the gathers may read; n_out: the rows of out that the grid writes,
// chunk b's rows from b * C (a rectangular launch writes a slice of
// destination chunks, whose src_chunk ids index every row of x).
struct Plan {
  int depth, planes, pack, n_rows, n_out, f;
  int vec;       // copy width of the x gather in bytes (16, 8, 4; 2: shifted)
  int odd0;      // with vec 2: whether x itself lies 2 bytes after a 4-byte boundary
  int list_cap;  // edges a list holds
  int batch;     // edges a gather buffer holds
  int stride;    // bytes between two edges' segments in a buffer
  int group;     // threads that share a row
  int area;      // bytes of the two gather buffers, at least the list's items
};

// One row's sum over one feature tile: the state of a thread.
template <typename T>
struct RowSum {
  const unsigned char* seg;  // this batch's buffer at the thread's columns
  const float* ssb;          // this batch's src scales, or null
  const uint32_t* edge;
  const float* ds;           // the chunk's dst scales in shared memory, or null
  T* out_col;                // out at (row 0 of the chunk, the thread's first column)
  int stride, e0, f, rows_left;
  // with the shifted gather a segment lies 2 * ((row & odd_rows) ^ odd0)
  // bytes into its slot: rows of odd length alternate, from x's own parity
  int odd_rows, odd0;
  int cols_left;             // live columns of the thread (<= 0: none)
  bool store_all;
  float acc[kCols];

  __device__ __forceinline__ void begin(int) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
  }

  __device__ __forceinline__ void edges(int lo, int hi) {
    if (cols_left <= 0) return;
    for (int e = lo; e < hi; ++e) {
      float v[kCols];
      const uint32_t ew = edge[e];
      Io<T>::load(seg + (size_t)(e - e0) * stride, (ew & odd_rows) ^ odd0,
                  ssb != nullptr, ssb != nullptr ? ssb[e - e0] : 1.f, v);
      const float m = static_cast<float>(ew >> 24);
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[k] += m * v[k];
    }
  }

  __device__ __forceinline__ void end(int row) {
    if (cols_left <= 0 || row >= rows_left) return;
    if (ds != nullptr) {
      const float scale = ds[row];
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[k] *= scale;
    }
    T* p = out_col + (size_t)row * f;
    if (cols_left >= kCols && store_all) {
      Io<T>::store_all(p, acc);
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (k < cols_left) Io<T>::store(p + k, acc[k]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bsda_spmm_kernel(const uint8_t* __restrict__ a,          // [B, planes, C, C]
                 const int32_t* __restrict__ src_chunk,  // [B, depth]
                 const T* __restrict__ x,                // [n_rows, f]
                 const float* __restrict__ ds,           // [B*C] or null
                 const float* __restrict__ ss,           // [n_rows] or null
                 T* __restrict__ out,                    // [n_out, f]
                 const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [2 gather buffers, under them the list's items | 2 src-scale buffers
  // (with ss) | dst scales | edge list]
  const size_t buf_bytes = (size_t)pl.batch * pl.stride;
  unsigned char* bufs = smem;
  float* ss_bufs = reinterpret_cast<float*>(smem + pl.area);
  float* ds_sm = ss_bufs + (ss != nullptr ? 2 * pl.batch : 0);
  const EdgeList ed =
      make_list(reinterpret_cast<unsigned char*>(ds_sm + kChunk), smem, pl.list_cap);

  const int b = blockIdx.x;
  const int rows_left = pl.n_out - b * kChunk;
  if (ds != nullptr && (int)threadIdx.x < min(kChunk, rows_left))
    cp_async<4>(ds_sm + threadIdx.x, ds + (size_t)b * kChunk + threadIdx.x);
  const uint32_t* planes_b = reinterpret_cast<const uint32_t*>(
      a + (size_t)b * pl.planes * (size_t)kPlaneBytes);
  const ChunkCounts cc = count_rows(planes_b, pl.planes, pl.pack,
                                    src_chunk + (size_t)b * pl.depth, pl.depth, ed);
  const bool whole = cc.edges <= pl.list_cap;  // the rule: one list for the chunk
  if (!whole) __syncthreads();                 // a hub chunk: the offsets, for group_end

  const int gid = threadIdx.x / pl.group;   // the thread's group
  const int c = threadIdx.x % pl.group;     // its place in it: columns 8c .. 8c + 7
  const int row_step = kThreads / pl.group;
  const int n_tiles = (pl.f + kTile - 1) / kTile;
  const size_t row_bytes = (size_t)pl.f * sizeof(T);

  RowSum<T> op;
  op.edge = ed.edge;
  op.ds = ds != nullptr ? ds_sm : nullptr;
  op.stride = pl.stride;
  op.f = pl.f;
  op.rows_left = rows_left;
  op.store_all = Io<T>::can_store_all(out, pl.f);
  op.odd_rows = pl.vec == 2 ? pl.f & 1 : 0;
  op.odd0 = pl.vec == 2 ? pl.odd0 : 0;

  for (int r0 = 0, r1; r0 < kChunk; r0 = r1) {
    r1 = whole ? kChunk : group_end(ed.edge_off, r0, pl.list_cap);
    fill_items(planes_b, pl.planes, ed, r0, r1,
               cc.item_start - (whole ? 0 : ed.item_off[r0]));
    __syncthreads();
    const int list0 = ed.edge_off[r0];
    const int n_edges = ed.edge_off[r1] - list0;
    expand_items(ed, ed.item_off[r1] - ed.item_off[r0], pl.pack, r0);
    // one tile whose edges fit the two buffers together: one batch in both
    const int batch = n_tiles == 1 && n_edges <= 2 * pl.batch ? 2 * pl.batch : pl.batch;
    const int n_batches = n_edges > 0 ? (n_edges + batch - 1) / batch : 1;
    const int items = n_tiles * n_batches;  // tile-major

    auto fetch = [&](int k) {
      const int tile = k / n_batches;
      const int e0 = (k - tile * n_batches) * batch;
      const int n = min(batch, n_edges - e0);
      const int cols = min(kTile, pl.f - tile * kTile);
      gather(pl.vec, bufs + (k & 1) * buf_bytes, pl.stride, x, row_bytes,
             tile * kTile * (int)sizeof(T), cols * (int)sizeof(T), ed.edge + e0, n,
             pl.n_rows);
      if (ss != nullptr)
        gather_rows<4>(reinterpret_cast<unsigned char*>(ss_bufs + (k & 1) * pl.batch),
                       4, reinterpret_cast<const unsigned char*>(ss), 4, 0, 4,
                       ed.edge + e0, n, pl.n_rows);
      cp_async_commit();
    };

    fetch(0);
    int row = 0;
    bool open = false;
    for (int k = 0; k < items; ++k) {
      cp_async_wait_all();
      __syncthreads();  // item k has landed; item k - 1's buffer is free
      if (k + 1 < items) fetch(k + 1);
      const int tile = k / n_batches;
      const int bi = k - tile * n_batches;
      if (bi == 0) {
        row = r0 + gid;
        open = false;
        const int col = tile * kTile + kCols * c;
        op.cols_left = pl.f - col;
        op.out_col = out + (size_t)b * kChunk * pl.f + col;
      }
      op.e0 = bi * batch;
      op.seg = bufs + (k & 1) * buf_bytes + kCols * c * sizeof(T);
      op.ssb = ss != nullptr ? ss_bufs + (k & 1) * pl.batch : nullptr;
      walk_rows(op, row, open, row_step, r1, ed.edge_off, list0, op.e0,
                min(op.e0 + batch, n_edges), bi == n_batches - 1);
    }
    __syncthreads();  // the list and the buffers are free for the next group
  }
}

template <typename T>
cudaError_t launch(const uint8_t* a, const int32_t* src_chunk, const void* x,
                   const float* ds, const float* ss, void* out, int num_chunks,
                   Plan pl, cudaStream_t stream) {
  const int cols = pl.f < kTile ? pl.f : kTile;
  pl.vec = copy_width(x, (size_t)pl.f * sizeof(T), kTile * sizeof(T));
  pl.odd0 = static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 1) & 1u);
  // a thread reads kCols values at once, and a half word more where the
  // segment is shifted: whole reads stay inside the slot
  pl.stride = round_up(round_up(cols, kCols) * (int)sizeof(T) + (pl.vec == 2 ? 4 : 0), 16);
  pl.list_cap = list_cap_for(pl.depth);
  pl.batch = batch_for(pl.stride);
  pl.group = group_size((cols + kCols - 1) / kCols);
  pl.area = buffer_area(pl.batch, pl.stride, pl.list_cap);
  const size_t smem = pl.area + (ss != nullptr ? 2 * (size_t)pl.batch * 4 : 0) + kChunk * 4 +
                      list_bytes(pl.list_cap, pl.depth);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bsda_spmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bsda_spmm_kernel<T><<<num_chunks, kThreads, smem, stream>>>(
      a, src_chunk, static_cast<const T*>(x), ds, ss, static_cast<T*>(out), pl);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The rectangular launch: num_chunks destination chunks (a, src_chunk and
// ds at the first of them) write out's n_out rows, reading the n_rows rows
// of x; src_chunk holds chunk ids of x. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
int bsda_spmm_launch_rect(const void* a, const void* src_chunk, const void* x,
                          const void* ds, const void* ss, void* out,
                          int num_chunks, int depth, int planes, int pack,
                          int n_rows, int n_out, int f, int dtype, void* stream) {
  if (num_chunks <= 0 || depth <= 0 || depth > kMaxDepth || f <= 0 || n_rows <= 0 ||
      n_rows > kMaxRows || n_out <= 0 || n_out > kMaxRows ||
      (pack != 1 && pack != 2 && pack != 4) || planes * pack < depth)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const int32_t* sc = static_cast<const int32_t*>(src_chunk);
  const float* dsf = static_cast<const float*>(ds);
  const float* ssf = static_cast<const float*>(ss);
  Plan pl = {};
  pl.depth = depth;
  pl.planes = planes;
  pl.pack = pack;
  pl.n_rows = n_rows;
  pl.n_out = n_out;
  pl.f = f;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(a8, sc, x, dsf, ssf, out, num_chunks, pl, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(a8, sc, x, dsf, ssf, out, num_chunks, pl, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The whole graph: out has the rows of x.
int bsda_spmm_launch(const void* a, const void* src_chunk, const void* x,
                     const void* ds, const void* ss, void* out,
                     int num_chunks, int depth, int planes, int pack,
                     int n_rows, int f, int dtype, void* stream) {
  return bsda_spmm_launch_rect(a, src_chunk, x, ds, ss, out, num_chunks, depth, planes,
                               pack, n_rows, n_rows, f, dtype, stream);
}

const char* bsda_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
