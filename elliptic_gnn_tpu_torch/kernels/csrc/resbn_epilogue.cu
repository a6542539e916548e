// The SAGE-ResBN hidden-layer epilogue for Hopper (sm_90a): from a SAGE
// convolution's output z [N, C] (f32) to the layer's output
//
//     out = dropout(relu(BN(z))) + res
//
// forward (training and eval) and backward, in a few row-streaming passes.
// BatchNorm and the residual are compile-time flags: the sage_resbn,
// sage_bn and sage_res variants of the family.
//
// Replaces no Pallas kernel: on the TPU, XLA fused this chain of
// BatchNorm, ReLU, dropout and the residual add into the operations around
// it (elliptic_gnn_tpu/models/modules.py). Run eagerly as PyTorch ops it is
// about twenty passes over [N, C] forward and twice that backward.
//
// What bounds it: bytes. An element takes a few flops; at Elliptic scale
// one [203,769 x 64] f32 tensor is 52 MB, 15.6 us at 3.35 TB/s. The
// training forward reads z for the column sums, then z, the uniform draw u
// and res, and writes out and one keep byte an element; the backward reads
// the cotangent g, z and the keep bytes for its column sums, then again
// for dz; the eval forward reads z and res once.
//
// Design: a thread owns 4 adjacent columns of a row (16-byte loads: the
// width is a multiple of 4 and every [N, C] operand starts on 16 bytes); a
// block of 256 threads covers 256 / (C / 4) rows at a time, and keeps
// its columns' coefficients (mean, inv, scale, bias, the backward's sums)
// in registers. Column sums are deterministic, with no float atomics:
// each block sums a fixed range of rows (its size set by the width alone,
// so that padding rows of weight 0 appended to the rows change no sum), in
// order, into per-block partials; a second kernel sums each column's
// partials in a fixed order. Two launches on the same inputs give the same
// bits. The apply passes walk the rows from the end, so that they first
// read what the sums pass before them left in L2.
//
// Numerics: the passes compute BatchNorm.forward's formula in its order of
// operations, each step rounded on its own (no contraction into FMAs):
// mean = s / n, var = max(sq / n - mean^2, 0), inv = rsqrt(var + 1e-5),
// y = relu((z - mean) * inv * scale + bias), out = (u < keep ? y * (1 /
// keep) : 0) + res (PyTorch's CUDA division by a scalar multiplies by its
// reciprocal); the running statistics move as the module moves them. Only
// the order of the column sums differs from ATen's. The backward is the
// gradient of that formula:
//
//     dy = g / keep where kept and y > 0, else 0
//     dz = scale * inv * (dy - m * (sum(dy) / n + xhat * sum(dy * xhat) / n))
//
// m the row's weight in the statistics (row_mask, else 1), the sums over
// every row (the sums of a process group where it shares the statistics),
// the second term dropped in a column whose variance clamp engaged.
//
// Plain C interface, loaded with ctypes (kernels/resbn_epilogue.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int V = 4;  // columns a thread: one float4
// the apply passes' grid at most (grid-stride): eight blocks of 256
// threads on each of the H100's 132 SMs
constexpr int kMaxBlocks = 1056;
// the sums passes' block: kSumIters rows a thread, so that a block's rows
// depend on the width alone. Rows added at the end with weight 0 (a mesh
// rank's padding, row_mask 0) then leave every sum of the rows before them
// as it was, bit for bit.
constexpr int kSumIters = 16;
constexpr float kEps = 1e-5f;        // models/modules.py BN_EPS
constexpr float kMomentum = 0.1f;    // BN_MOMENTUM
constexpr float kKeepRunning = 0.9f; // 1 - BN_MOMENTUM

struct Shape {
  long long rows;
  int c;    // columns
  int tpr;  // threads a row: c / V
  int rpi;  // rows a block covers at a time: kThreads / tpr
};

bool make_shape(long long rows, int c, Shape* sh) {
  if (rows <= 0 || c <= 0 || c % V != 0 || c / V > kThreads) return false;
  sh->rows = rows;
  sh->c = c;
  sh->tpr = c / V;
  sh->rpi = kThreads / sh->tpr;
  return true;
}

// The sums passes' plan: blocks of `rows_per_block` rows (kSumIters row
// slots), as many as the rows need.
int sum_blocks(const Shape& sh, long long* rows_per_block) {
  const long long per = static_cast<long long>(kSumIters) * sh.rpi;
  *rows_per_block = per;
  return static_cast<int>((sh.rows + per - 1) / per);
}

// Where a pass finds the normalisation: the batch statistics (training,
// `stats` = [n, sum z, sum z^2]) or the running ones (eval, stats null).
struct Norm {
  const float* stats;
  const float* rmean;
  const float* rvar;
  const float* scale;
  const float* bias;
};

__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[V]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[V]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ p, bool (&b)[V]) {
  const uchar4 t = *reinterpret_cast<const uchar4*>(p);
  b[0] = t.x;
  b[1] = t.y;
  b[2] = t.z;
  b[3] = t.w;
}

__device__ __forceinline__ void store_bytes(uint8_t* __restrict__ p, const bool (&b)[V]) {
  *reinterpret_cast<uchar4*>(p) = make_uchar4(b[0], b[1], b[2], b[3]);
}

// Column j's mean and inverse deviation from the batch statistics, in
// BatchNorm.forward's order of operations; `clamped`: the variance's clamp
// engaged (its gradient is then zero, as torch.clamp's).
__device__ __forceinline__ void batch_moments(const float* __restrict__ stats, int c, int j,
                                              float* mean, float* var, float* inv,
                                              bool* clamped) {
  const float n = stats[0];
  *mean = __fdiv_rn(stats[1 + j], n);
  const float raw = __fsub_rn(__fdiv_rn(stats[1 + c + j], n), __fmul_rn(*mean, *mean));
  *clamped = raw < 0.f;
  *var = *clamped ? 0.f : raw;
  *inv = rsqrtf(__fadd_rn(*var, kEps));
}

// A thread's columns' coefficients: mean, inv, scale, bias, clamped.
struct Cols {
  float mean[V], inv[V], scale[V], bias[V], var[V];
  bool clamped[V];

  __device__ __forceinline__ void read(const Norm& nm, int c, int col0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = col0 + k;
      if (nm.stats != nullptr) {
        batch_moments(nm.stats, c, j, &mean[k], &var[k], &inv[k], &clamped[k]);
      } else {
        mean[k] = nm.rmean[j];
        var[k] = nm.rvar[j];
        inv[k] = rsqrtf(__fadd_rn(var[k], kEps));
        clamped[k] = false;
      }
      scale[k] = nm.scale[j];
      bias[k] = nm.bias[j];
    }
  }
};

__device__ __forceinline__ float xhat(float z, float mean, float inv) {
  return __fmul_rn(__fsub_rn(z, mean), inv);
}

__device__ __forceinline__ float affine(float xh, float scale, float bias) {
  return __fadd_rn(__fmul_rn(xh, scale), bias);
}

// dy of one element: g where the ReLU passed (y > 0) and the element was
// kept, times 1/keep where dropout ran (`kept` null: no dropout)
__device__ __forceinline__ float relu_drop_grad(float g, float y, const bool* kept,
                                                float inv_keep) {
  if (y <= 0.f) return 0.f;
  if (kept == nullptr) return g;
  return *kept ? __fmul_rn(g, inv_keep) : 0.f;
}

// Per-block sums of V columns a thread over rows [begin, end) into the
// block's partials row (`out`, `nq` quantities of c columns after `head`
// leading entries): thread sums in row order, then a fixed-order sum over
// the block's row slots in shared memory.
template <int NQ>
__device__ __forceinline__ void block_partials(const Shape& sh, int lane, int r0, bool active,
                                               const float (&acc)[NQ][V], float* __restrict__ out,
                                               int head) {
  __shared__ float sh_acc[NQ][kThreads * V];
  if (active) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int k = 0; k < V; ++k) sh_acc[q][r0 * sh.c + lane * V + k] = acc[q][k];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < sh.c; j += kThreads) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float t = 0.f;
      for (int r = 0; r < sh.rpi; ++r) t += sh_acc[q][r * sh.c + j];
      out[head + q * sh.c + j] = t;
    }
  }
}

// Training forward, pass 1: per-block partials [count, sum z, sum z^2] of
// the rows, weighted by row_mask where given.
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const float* __restrict__ z, const float* __restrict__ row_mask, Shape sh,
                 long long rows_per_block, float* __restrict__ partials) {
  __shared__ float sh_n[kThreads];
  const int lane = threadIdx.x % sh.tpr, r0 = threadIdx.x / sh.tpr;
  const bool active = r0 < sh.rpi;
  float acc[2][V] = {};
  float cnt = 0.f;
  if (active) {
    const long long begin = blockIdx.x * rows_per_block;
    const long long end = begin + rows_per_block < sh.rows ? begin + rows_per_block : sh.rows;
#pragma unroll 4
    for (long long r = begin + r0; r < end; r += sh.rpi) {
      float v[V];
      load(z + r * sh.c + lane * V, v);
      // each product rounded as BatchNorm's (h * m, h * h * m): a weight
      // of 1 gives the bits of no mask, a weight of 0 adds nothing
      const float m = row_mask != nullptr ? row_mask[r] : 1.f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        acc[0][k] = __fadd_rn(acc[0][k], __fmul_rn(v[k], m));
        acc[1][k] = __fadd_rn(acc[1][k], __fmul_rn(__fmul_rn(v[k], v[k]), m));
      }
      cnt += m;
    }
    if (lane == 0) sh_n[r0] = cnt;
  }
  float* out = partials + blockIdx.x * (1 + 2 * sh.c);
  block_partials<2>(sh, lane, r0, active, acc, out, 1);
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int r = 0; r < sh.rpi; ++r) t += sh_n[r];
    out[0] = t;
  }
}

// out[j] = the sum over blocks of partials[b, j], j < width, in a fixed
// order: the 32 threads of a column each sum every 32nd block's partial in
// order, then one sums their 32 sums in order. (A row count without a mask
// is a sum of 1s: exact below 2^24 rows.)
__global__ void __launch_bounds__(1024)
    col_sums_kernel(const float* __restrict__ partials, int blocks, int width,
                    float* __restrict__ out) {
  __shared__ float sh[32][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f;
  if (j < width)
    for (int b = threadIdx.y; b < blocks; b += 32)
      a += partials[static_cast<long long>(b) * width + j];
  sh[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float t = 0.f;
    for (int y = 0; y < 32; ++y) t += sh[y][threadIdx.x];
    out[j] = t;
  }
}

struct Apply {
  const float* z;
  const float* u;  // the uniform draw; null: no dropout
  float keep;
  const float* res;
  float* out;
  uint8_t* keep_mask;  // u < keep, written where u is given
  float* run_mean;     // the running statistics, moved by block 0 in training
  float* run_var;
  float* run_count;
};

// The forward's apply pass, training (nm.stats) or eval.
template <bool BN, bool RES>
__global__ void __launch_bounds__(kThreads) apply_kernel(Apply a, Norm nm, Shape sh) {
  const int lane = threadIdx.x % sh.tpr, r0 = threadIdx.x / sh.tpr;
  if (r0 >= sh.rpi) return;
  const int col0 = lane * V;
  Cols cols;
  if constexpr (BN) {
    cols.read(nm, sh.c, col0);
    if (nm.stats != nullptr && a.run_mean != nullptr && blockIdx.x == 0 && r0 == 0) {
      // BatchNorm.forward: running = 0.9 running + 0.1 batch, the variance
      // unbiased by n / max(n - 1, 1)
      const float n = nm.stats[0];
      const float nm1 = __fsub_rn(n, 1.f);
      const float den = nm1 < 1.f ? 1.f : nm1;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = col0 + k;
        const float unbiased = __fdiv_rn(__fmul_rn(cols.var[k], n), den);
        a.run_mean[j] = __fadd_rn(__fmul_rn(a.run_mean[j], kKeepRunning),
                                  __fmul_rn(cols.mean[k], kMomentum));
        a.run_var[j] = __fadd_rn(__fmul_rn(a.run_var[j], kKeepRunning),
                                 __fmul_rn(unbiased, kMomentum));
      }
      if (lane == 0) *a.run_count = __fadd_rn(*a.run_count, 1.f);
    }
  }
  const bool drop = a.u != nullptr;
  const float inv_keep = __fdiv_rn(1.f, a.keep);
  const long long groups = (sh.rows + sh.rpi - 1) / sh.rpi;
  for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x) {
    const long long r = (groups - 1 - gi) * sh.rpi + r0;
    if (r >= sh.rows) continue;
    const long long off = r * sh.c + col0;
    float v[V], u[V], rs[V];
    bool kept[V];
    load(a.z + off, v);
    if (drop) load(a.u + off, u);
    if constexpr (RES) load(a.res + off, rs);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float y = v[k];
      if constexpr (BN) y = affine(xhat(y, cols.mean[k], cols.inv[k]), cols.scale[k], cols.bias[k]);
      y = y < 0.f ? 0.f : y;
      if (drop) {
        kept[k] = u[k] < a.keep;
        y = kept[k] ? __fmul_rn(y, inv_keep) : 0.f;
      }
      if constexpr (RES) y = __fadd_rn(y, rs[k]);
      v[k] = y;
    }
    store(a.out + off, v);
    if (drop) store_bytes(a.keep_mask + off, kept);
  }
}

struct Bwd {
  const float* g;
  const float* z;
  const uint8_t* keep_mask;  // null: no dropout
  float keep;
};

// The backward, pass 1 (BatchNorm): per-block partials [sum dy, sum dy *
// xhat].
__global__ void __launch_bounds__(kThreads)
    bwd_sums_kernel(Bwd b, Norm nm, Shape sh, long long rows_per_block,
                    float* __restrict__ partials) {
  const int lane = threadIdx.x % sh.tpr, r0 = threadIdx.x / sh.tpr;
  const bool active = r0 < sh.rpi;
  const int col0 = lane * V;
  float acc[2][V] = {};
  if (active) {
    Cols cols;
    cols.read(nm, sh.c, col0);
    const float inv_keep = __fdiv_rn(1.f, b.keep);
    const long long begin = blockIdx.x * rows_per_block;
    const long long end = begin + rows_per_block < sh.rows ? begin + rows_per_block : sh.rows;
#pragma unroll 2
    for (long long r = begin + r0; r < end; r += sh.rpi) {
      const long long off = r * sh.c + col0;
      float g[V], v[V];
      bool kept[V];
      load(b.g + off, g);
      load(b.z + off, v);
      if (b.keep_mask != nullptr) load_bytes(b.keep_mask + off, kept);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = xhat(v[k], cols.mean[k], cols.inv[k]);
        const float dy = relu_drop_grad(g[k], affine(xh, cols.scale[k], cols.bias[k]),
                                        b.keep_mask != nullptr ? &kept[k] : nullptr, inv_keep);
        acc[0][k] += dy;
        acc[1][k] += dy * xh;
      }
    }
  }
  block_partials<2>(sh, lane, r0, active, acc, partials + blockIdx.x * 2 * sh.c, 0);
}

// The backward's dz pass. Training (nm.stats): `sums` = [sum dy, sum dy *
// xhat] over every row (of the group), row_mask the rows' weights in the
// statistics; eval: dz = dy * scale * inv.
template <bool BN>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(Bwd b, Norm nm, const float* __restrict__ sums,
               const float* __restrict__ row_mask, Shape sh, float* __restrict__ dz) {
  const int lane = threadIdx.x % sh.tpr, r0 = threadIdx.x / sh.tpr;
  if (r0 >= sh.rpi) return;
  const int col0 = lane * V;
  Cols cols;
  float mean_dy[V], mean_dyx[V], k_inv[V];
  if constexpr (BN) {
    cols.read(nm, sh.c, col0);
    if (nm.stats != nullptr) {
      const float n = nm.stats[0];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = col0 + k;
        mean_dy[k] = sums[j] / n;
        mean_dyx[k] = cols.clamped[k] ? 0.f : sums[sh.c + j] / n;
        k_inv[k] = cols.scale[k] * cols.inv[k];
      }
    }
  }
  const float inv_keep = __fdiv_rn(1.f, b.keep);
  const long long groups = (sh.rows + sh.rpi - 1) / sh.rpi;
  for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x) {
    const long long r = (groups - 1 - gi) * sh.rpi + r0;
    if (r >= sh.rows) continue;
    const long long off = r * sh.c + col0;
    float g[V], v[V];
    bool kept[V];
    load(b.g + off, g);
    load(b.z + off, v);
    if (b.keep_mask != nullptr) load_bytes(b.keep_mask + off, kept);
    const float m = row_mask != nullptr ? row_mask[r] : 1.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool* kp = b.keep_mask != nullptr ? &kept[k] : nullptr;
      if constexpr (BN) {
        const float xh = xhat(v[k], cols.mean[k], cols.inv[k]);
        const float dy =
            relu_drop_grad(g[k], affine(xh, cols.scale[k], cols.bias[k]), kp, inv_keep);
        if (nm.stats != nullptr)
          v[k] = k_inv[k] * (dy - m * (mean_dy[k] + xh * mean_dyx[k]));
        else
          v[k] = __fmul_rn(__fmul_rn(dy, cols.scale[k]), cols.inv[k]);
      } else {
        v[k] = relu_drop_grad(g[k], v[k], kp, inv_keep);
      }
    }
    store(dz + off, v);
  }
}

int apply_grid(const Shape& sh) {
  const long long groups = (sh.rows + sh.rpi - 1) / sh.rpi;
  return static_cast<int>(groups < kMaxBlocks ? groups : kMaxBlocks);
}

template <bool BN, bool RES>
cudaError_t launch_apply(const Apply& a, const Norm& nm, const Shape& sh, cudaStream_t s) {
  apply_kernel<BN, RES><<<apply_grid(sh), kThreads, 0, s>>>(a, nm, sh);
  return cudaGetLastError();
}

bool norm_ok(const Norm& nm) {
  return nm.scale != nullptr && nm.bias != nullptr &&
         (nm.stats != nullptr || (nm.rmean != nullptr && nm.rvar != nullptr));
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

extern "C" {

// The sums passes' grid for [rows, c]: returns the number of blocks (a
// partials buffer holds that many rows), -1 if the shape is not taken.
int resbn_sum_blocks(long long rows, int c) {
  Shape sh;
  if (!make_shape(rows, c, &sh)) return -1;
  long long per;
  return sum_blocks(sh, &per);
}

// Training forward, pass 1: partials [blocks, 1 + 2c] of [count, sum z,
// sum z^2] (row_mask may be null). Each launch returns its cudaError_t.
int resbn_stats_launch(const void* z, const void* row_mask, long long rows, int c,
                       void* partials, void* stream) {
  Shape sh;
  if (!make_shape(rows, c, &sh) || z == nullptr || partials == nullptr) return invalid();
  long long per;
  const int blocks = sum_blocks(sh, &per);
  stats_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(row_mask), sh, per,
      static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// out[width] = the column sums of partials [blocks, width].
int resbn_col_sums_launch(const void* partials, int blocks, int width, void* out,
                          void* stream) {
  if (partials == nullptr || out == nullptr || blocks <= 0 || width <= 0) return invalid();
  col_sums_kernel<<<(width + 31) / 32, dim3(32, 32), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), blocks, width, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The forward's apply pass: out (and keep_mask where u is given) from z,
// the normalisation (bn: stats [1 + 2c] in training, with the running
// statistics moved in place; else rmean, rvar), u, res (residual).
int resbn_apply_launch(const void* z, const void* stats, const void* rmean, const void* rvar,
                       const void* scale, const void* bias, const void* u, float keep,
                       const void* res, void* out, void* keep_mask, void* run_mean,
                       void* run_var, void* run_count, long long rows, int c, int bn,
                       int residual, void* stream) {
  Shape sh;
  Norm nm = {static_cast<const float*>(stats), static_cast<const float*>(rmean),
             static_cast<const float*>(rvar), static_cast<const float*>(scale),
             static_cast<const float*>(bias)};
  Apply a = {static_cast<const float*>(z), static_cast<const float*>(u), keep,
             static_cast<const float*>(res), static_cast<float*>(out),
             static_cast<uint8_t*>(keep_mask), static_cast<float*>(run_mean),
             static_cast<float*>(run_var), static_cast<float*>(run_count)};
  if (!make_shape(rows, c, &sh) || a.z == nullptr || a.out == nullptr ||
      (bn && !norm_ok(nm)) || (residual && a.res == nullptr) ||
      (a.u != nullptr && (a.keep_mask == nullptr || !(keep > 0.f && keep <= 1.f))) ||
      ((a.run_mean != nullptr) != (a.run_var != nullptr && a.run_count != nullptr)))
    return invalid();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn && residual) return static_cast<int>(launch_apply<true, true>(a, nm, sh, s));
  if (bn) return static_cast<int>(launch_apply<true, false>(a, nm, sh, s));
  if (residual) return static_cast<int>(launch_apply<false, true>(a, nm, sh, s));
  return static_cast<int>(launch_apply<false, false>(a, nm, sh, s));
}

// The backward, pass 1 (bn only): partials [blocks, 2c] of [sum dy, sum dy
// * xhat], with the normalisation as the forward had it.
int resbn_bwd_sums_launch(const void* g, const void* z, const void* keep_mask, float keep,
                          const void* stats, const void* rmean, const void* rvar,
                          const void* scale, const void* bias, long long rows, int c,
                          void* partials, void* stream) {
  Shape sh;
  Norm nm = {static_cast<const float*>(stats), static_cast<const float*>(rmean),
             static_cast<const float*>(rvar), static_cast<const float*>(scale),
             static_cast<const float*>(bias)};
  Bwd b = {static_cast<const float*>(g), static_cast<const float*>(z),
           static_cast<const uint8_t*>(keep_mask), keep};
  if (!make_shape(rows, c, &sh) || b.g == nullptr || b.z == nullptr || !norm_ok(nm) ||
      partials == nullptr || !(keep > 0.f && keep <= 1.f))
    return invalid();
  long long per;
  const int blocks = sum_blocks(sh, &per);
  bwd_sums_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      b, nm, sh, per, static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// The backward's dz pass: bn with stats (training) takes `sums` [2c] and
// row_mask (may be null); bn without stats (eval) neither.
int resbn_bwd_launch(const void* g, const void* z, const void* keep_mask, float keep,
                     const void* stats, const void* rmean, const void* rvar, const void* scale,
                     const void* bias, const void* sums, const void* row_mask, void* dz,
                     long long rows, int c, int bn, void* stream) {
  Shape sh;
  Norm nm = {static_cast<const float*>(stats), static_cast<const float*>(rmean),
             static_cast<const float*>(rvar), static_cast<const float*>(scale),
             static_cast<const float*>(bias)};
  Bwd b = {static_cast<const float*>(g), static_cast<const float*>(z),
           static_cast<const uint8_t*>(keep_mask), keep};
  if (!make_shape(rows, c, &sh) || b.g == nullptr || b.z == nullptr || dz == nullptr ||
      !(keep > 0.f && keep <= 1.f) ||
      (bn && (!norm_ok(nm) || (nm.stats != nullptr && sums == nullptr))))
    return invalid();
  const float* sf = static_cast<const float*>(sums);
  const float* mf = static_cast<const float*>(row_mask);
  float* df = static_cast<float*>(dz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn)
    bwd_kernel<true><<<apply_grid(sh), kThreads, 0, s>>>(b, nm, sf, mf, sh, df);
  else
    bwd_kernel<false><<<apply_grid(sh), kThreads, 0, s>>>(b, nm, sf, mf, sh, df);
  return static_cast<int>(cudaGetLastError());
}

const char* resbn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
