// EvolveGCN-O's weight evolution for Hopper (sm_90a): the matrix GRU that
// turns a GRCU layer's weights Q_{t-1} [d, c] into Q_t, one snapshot at a
// time, forward and backward through time (f32 throughout):
//
//     U  = sigmoid(W_u Q + U_u Q + B_u)
//     R  = sigmoid(W_r Q + U_r Q + B_r)
//     H~ = tanh((W_h Q + B_h) + U_h (R o Q))
//     Q' = (1 - U) o Q + U o H~
//
// W_*, U_* [d, d], B_* [d, c] (Pareja et al., arXiv:1902.10191; the code's
// mat_GRU_cell, with Q as both its input and its hidden state).
//
// Replaces no Pallas kernel: the JAX package has no temporal model. Added
// for EvolveGCN-O (models/egcn.py), whose chain of 49 dependent steps a
// layer is bound by latency and occupancy: one step is six products of a
// [d, d] by a [d, c] matrix (d 166 or 256, c 256: 85 or 201 MFLOP), too
// small to fill the card, and no step can start before the last has ended.
//
// Design: one launch a stage, each over tiles of 16 x 32 outputs, so that a
// step has 48 to 128 tiles for the 132 SMs. A block is several warps; each
// warp computes one product of its tile over a fixed range of its depth,
// chunks of 32 staged in the warp's own shared memory (no block barrier in
// the depth loop), a lane 4 x 4 outputs from one float4 of A and one of B a
// depth step, so that shared memory serves 16 multiply-adds per two reads.
// The warps' sums meet in shared memory and are added in a fixed order in
// the epilogue, which also applies the gates. No atomics: two launches on
// the same inputs give the same bits.
//
//   forward   egcn_gates_kernel   five products (W_u Q, U_u Q, W_r Q, U_r Q,
//                                 W_h Q), four warps each over the depth;
//                                 writes U, R and P = W_h Q + B_h
//             egcn_update_kernel  eight warps over the depth of U_h (R o Q)
//                                 (R o Q formed as it is staged); writes H~
//                                 and Q'
//   backward  egcn_bwd_gate_kernel  eight warps over the depth of
//                                 U_h^T dA_h, dA_h = dQ' o U o (1 - H~^2)
//                                 formed as it is staged; writes dA_h, dA_u,
//                                 dA_r and dQ's direct part
//             egcn_bwd_dq_kernel  five products, four warps each: W_h^T dA_h,
//                                 W_u^T dA_u, U_u^T dA_u, W_r^T dA_r,
//                                 U_r^T dA_r, added to the direct part (and
//                                 to the cotangent Q_{t-1} takes from its
//                                 own use, where given): dQ
//             egcn_wgrad_kernel   once after the chain: the weights'
//                                 gradients, sums over all steps at once
//                                 (depth steps x c): dW_h = sum dA_h Q^T,
//                                 dU_h = sum dA_h (R o Q)^T, dW_u = dU_u =
//                                 sum dA_u Q^T, dW_r = dU_r = sum dA_r Q^T
//             egcn_bias_sum_kernel  dB_* = sum over the steps of dA_*
//
// Numerics: each product sums in f32 with fused multiply-adds, the warps'
// partial sums added in order; sigmoid as 1 / (1 + expf(-x)) and tanhf, as
// ATen computes them on the card. Only the order of the sums differs from
// cuBLAS's.
//
// Plain C interface, loaded with ctypes (kernels/egcn_evolve.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 16;    // output rows of a tile
constexpr int TN = 32;    // output columns of a tile
constexpr int TK = 32;    // depth of a staged chunk
constexpr int TILE = TM * TN;
constexpr int WARP = 32;  // a warp computes a tile's sums over its depth range, 4 x 4 a lane

// A warp's staged chunk: A's rows k-major (a[kk][row]), B's [kk][col]; rows
// padded to keep each float4 read on 16 bytes.
struct __align__(16) Stage {
  float a[TK][TM + 4];
  float b[TK][TN + 4];
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// The cotangent of H~'s pre-activation from dQ': dQ' o U o (1 - H~^2).
__device__ __forceinline__ float dah_of(float dqn, float u, float h) {
  return dqn * u * (1.f - h * h);
}

// A lane's share of one staged chunk, fetched into registers first (all its
// loads in flight together, the next chunk's while this one is multiplied),
// then put into its warp's Stage.
struct Frag {
  float a[TM * TK / WARP];  // 16
  float4 b[TK * TN / WARP / 4];  // 8
};

// Rows i0.. and depths k0.. of an operand A, zero outside [rows, depth):
// A[i * lda + k], or with TRANS A[k * lda + i] (the product takes A's
// transpose). With `vec` (the contiguous extent and lda multiples of 4) a
// lane loads float4s; else scalars, lanes walking the rows fastest so that
// the stores are free of bank conflicts and a lane's later loads hit the
// lines its earlier ones brought.
template <bool TRANS>
__device__ __forceinline__ void fetch_a(Frag& f, const float* __restrict__ A, int lda, int i0,
                                        int rows, int k0, int depth, int lane, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < TM * TK / WARP / 4; ++q) {
      const int e = lane + q * WARP;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (TRANS) {  // 4 rows i of depth k: A[k][i..i+3]
        const int m = e % (TM / 4), kk = e / (TM / 4);
        const int i = i0 + 4 * m, k = k0 + kk;
        if (i < rows && k < depth)
          v = *reinterpret_cast<const float4*>(A + static_cast<long long>(k) * lda + i);
      } else {  // 4 depths k of row i: A[i][k..k+3]
        const int r = e % TM, m = e / TM;
        const int i = i0 + r, k = k0 + 4 * m;
        if (i < rows && k < depth)
          v = *reinterpret_cast<const float4*>(A + static_cast<long long>(i) * lda + k);
      }
      f.a[4 * q] = v.x;
      f.a[4 * q + 1] = v.y;
      f.a[4 * q + 2] = v.z;
      f.a[4 * q + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < TM * TK / WARP; ++q) {
    const int e = lane + q * WARP;
    const int r = e % TM, kk = e / TM;
    const int i = i0 + r, k = k0 + kk;
    float v = 0.f;
    if (i < rows && k < depth)
      v = TRANS ? A[static_cast<long long>(k) * lda + i] : A[static_cast<long long>(i) * lda + k];
    f.a[q] = v;
  }
}

template <bool TRANS>
__device__ __forceinline__ void put_a(Stage& s, const Frag& f, int lane, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < TM * TK / WARP / 4; ++q) {
      const int e = lane + q * WARP;
      if (TRANS) {
        const int m = e % (TM / 4), kk = e / (TM / 4);
        *reinterpret_cast<float4*>(&s.a[kk][4 * m]) =
            make_float4(f.a[4 * q], f.a[4 * q + 1], f.a[4 * q + 2], f.a[4 * q + 3]);
      } else {
        const int r = e % TM, m = e / TM;
#pragma unroll
        for (int v = 0; v < 4; ++v) s.a[4 * m + v][r] = f.a[4 * q + v];
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < TM * TK / WARP; ++q) {
    const int e = lane + q * WARP;
    s.a[e / TM][e % TM] = f.a[q];
  }
}

// Depths k0.. and columns j0.. of an operand B [depth, cols] (row-major,
// `cols` a row, a multiple of 4), four columns at a time f.at4(flat
// index), zero outside.
template <class F>
__device__ __forceinline__ void fetch_b(Frag& fr, F f, int cols, int j0, int k0, int depth,
                                        int lane) {
#pragma unroll
  for (int q = 0; q < TK * TN / WARP / 4; ++q) {
    const int e = lane + q * WARP;
    const int j4 = e % (TN / 4), kk = e / (TN / 4);
    const int k = k0 + kk, j = j0 + 4 * j4;
    fr.b[q] = (k < depth && j < cols) ? f.at4(static_cast<long long>(k) * cols + j)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void put_b(Stage& s, const Frag& f, int lane) {
#pragma unroll
  for (int q = 0; q < TK * TN / WARP / 4; ++q) {
    const int e = lane + q * WARP;
    *reinterpret_cast<float4*>(&s.b[e / (TN / 4)][4 * (e % (TN / 4))]) = f.b[q];
  }
}

__device__ __forceinline__ float4 ld4(const float* __restrict__ x, long long i) {
  return *reinterpret_cast<const float4*>(x + i);
}

struct Plain {
  const float* __restrict__ x;
  __device__ float4 at4(long long i) const { return ld4(x, i); }
};

struct Prod {  // x o y
  const float* __restrict__ x;
  const float* __restrict__ y;
  __device__ float4 at4(long long i) const {
    const float4 a = ld4(x, i), b = ld4(y, i);
    return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
  }
};

struct Dah {  // dA_h formed from dQ', U and H~
  const float* __restrict__ dqn;
  const float* __restrict__ u;
  const float* __restrict__ h;
  __device__ float4 at4(long long i) const {
    const float4 g = ld4(dqn, i), uu = ld4(u, i), hh = ld4(h, i);
    return make_float4(dah_of(g.x, uu.x, hh.x), dah_of(g.y, uu.y, hh.y),
                       dah_of(g.z, uu.z, hh.z), dah_of(g.w, uu.w, hh.w));
  }
};

// acc[i][j] += sum over the chunk of a[kk][4 rg + i] * b[kk][4 cg + j]
__device__ __forceinline__ void mma(const Stage& s, int rg, int cg, float (&acc)[4][4]) {
#pragma unroll 8
  for (int kk = 0; kk < TK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&s.a[kk][4 * rg]);
    const float4 b = *reinterpret_cast<const float4*>(&s.b[kk][4 * cg]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// A block's shared memory (dynamic, declared in each kernel): each warp's
// Stage during the depth loop, then the warps' sums red[warp][TILE] in the
// same bytes.
__host__ __device__ constexpr int smem_bytes(int warps) {
  return warps * static_cast<int>(sizeof(Stage));
}

// After the depth loop: every warp's sums into red[warp], then a barrier.
__device__ __forceinline__ float* gather(unsigned char* smem, const float (&acc)[4][4], int w,
                                         int rg, int cg) {
  __syncthreads();  // every warp has left its Stage
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[w * TILE + (4 * rg + i) * TN + 4 * cg + j] = acc[i][j];
  __syncthreads();
  return red;
}

// Product p's sum at element e: its S warps' sums, in order.
template <int S>
__device__ __forceinline__ float part(const float* red, int p, int e) {
  float v = red[(p * S) * TILE + e];
#pragma unroll
  for (int s = 1; s < S; ++s) v += red[(p * S + s) * TILE + e];
  return v;
}

// A warp's range of chunks: chunks split * per .. of `chunks`.
struct Range {
  int first, end;
  __device__ Range(int chunks, int splits, int split) {
    const int per = (chunks + splits - 1) / splits;
    first = split * per;
    end = min(chunks, first + per);
  }
};

struct Lane {
  int w, lane, rg, cg;
  __device__ Lane()
      : w(threadIdx.x / WARP), lane(threadIdx.x % WARP), rg(lane / (TN / 4)),
        cg(lane % (TN / 4)) {}
};

// The depth loop of one warp over a product A (rows x depth, lda a row)
// times B (depth x cols, f.at4), over the chunks of `rg`, each chunk's loads
// issued while the one before is multiplied.
template <bool TRANS, class F>
__device__ __forceinline__ void product(Stage& s, const Lane& l, const float* A, int lda,
                                        F f, int cols, int i0, int j0, int rows, int depth,
                                        Range rg, float (&acc)[4][4]) {
  const bool vec = lda % 4 == 0 && (TRANS ? rows : depth) % 4 == 0;
  Frag fr;
  if (rg.first < rg.end) {
    fetch_a<TRANS>(fr, A, lda, i0, rows, rg.first * TK, depth, l.lane, vec);
    fetch_b(fr, f, cols, j0, rg.first * TK, depth, l.lane);
  }
  for (int ch = rg.first; ch < rg.end; ++ch) {
    put_a<TRANS>(s, fr, l.lane, vec);
    put_b(s, fr, l.lane);
    __syncwarp();
    if (ch + 1 < rg.end) {
      fetch_a<TRANS>(fr, A, lda, i0, rows, (ch + 1) * TK, depth, l.lane, vec);
      fetch_b(fr, f, cols, j0, (ch + 1) * TK, depth, l.lane);
    }
    mma(s, l.rg, l.cg, acc);
    __syncwarp();
  }
}

constexpr int GATE_SPLITS = 4;  // gates and bwd_dq: 5 products x 4 = 20 warps
constexpr int ONE_SPLITS = 8;   // update, bwd_gate, wgrad: one product x 8 warps

struct GatesArgs {
  const float* w[5];  // W_u, U_u, W_r, U_r, W_h
  const float* bu;
  const float* br;
  const float* bh;
  const float* q;
  float* u;
  float* r;
  float* p;
  int d, c;
};

__global__ void __launch_bounds__(5 * GATE_SPLITS * WARP) egcn_gates_kernel(GatesArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);
  const Lane l;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  const int p = l.w / GATE_SPLITS;
  float acc[4][4] = {};
  product<false>(st[l.w], l, a.w[p], a.d, Plain{a.q}, a.c, i0, j0, a.d, a.d,
                 Range((a.d + TK - 1) / TK, GATE_SPLITS, l.w % GATE_SPLITS), acc);
  const float* red = gather(smem, acc, l.w, l.rg, l.cg);
  for (int e = threadIdx.x; e < TILE; e += blockDim.x) {
    const int i = i0 + e / TN, j = j0 + e % TN;
    if (i >= a.d || j >= a.c) continue;
    const long long x = static_cast<long long>(i) * a.c + j;
    a.u[x] = sigmoid_f(part<GATE_SPLITS>(red, 0, e) + part<GATE_SPLITS>(red, 1, e) + a.bu[x]);
    a.r[x] = sigmoid_f(part<GATE_SPLITS>(red, 2, e) + part<GATE_SPLITS>(red, 3, e) + a.br[x]);
    a.p[x] = part<GATE_SPLITS>(red, 4, e) + a.bh[x];
  }
}

struct UpdateArgs {
  const float* uh;
  const float* q;
  const float* r;
  const float* u;
  const float* p;
  float* h;
  float* qn;
  int d, c;
};

__global__ void __launch_bounds__(ONE_SPLITS * WARP) egcn_update_kernel(UpdateArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);
  const Lane l;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  float acc[4][4] = {};
  product<false>(st[l.w], l, a.uh, a.d, Prod{a.r, a.q}, a.c, i0, j0, a.d, a.d,
                 Range((a.d + TK - 1) / TK, ONE_SPLITS, l.w), acc);
  const float* red = gather(smem, acc, l.w, l.rg, l.cg);
  for (int e = threadIdx.x; e < TILE; e += blockDim.x) {
    const int i = i0 + e / TN, j = j0 + e % TN;
    if (i >= a.d || j >= a.c) continue;
    const long long x = static_cast<long long>(i) * a.c + j;
    const float h = tanhf(a.p[x] + part<ONE_SPLITS>(red, 0, e));
    const float u = a.u[x];
    a.h[x] = h;
    a.qn[x] = (1.f - u) * a.q[x] + u * h;
  }
}

struct BwdGateArgs {
  const float* uh;
  const float* dqn;
  const float* u;
  const float* h;
  const float* q;
  const float* r;
  float* dah;
  float* dau;
  float* dar;
  float* dqp;
  int d, c;
};

__global__ void __launch_bounds__(ONE_SPLITS * WARP) egcn_bwd_gate_kernel(BwdGateArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);
  const Lane l;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  float acc[4][4] = {};
  product<true>(st[l.w], l, a.uh, a.d, Dah{a.dqn, a.u, a.h}, a.c, i0, j0, a.d, a.d,
                Range((a.d + TK - 1) / TK, ONE_SPLITS, l.w), acc);
  const float* red = gather(smem, acc, l.w, l.rg, l.cg);
  for (int e = threadIdx.x; e < TILE; e += blockDim.x) {
    const int i = i0 + e / TN, j = j0 + e % TN;
    if (i >= a.d || j >= a.c) continue;
    const long long x = static_cast<long long>(i) * a.c + j;
    const float grq = part<ONE_SPLITS>(red, 0, e);  // d(R o Q)
    const float dqn = a.dqn[x], u = a.u[x], h = a.h[x], q = a.q[x], rr = a.r[x];
    a.dah[x] = dah_of(dqn, u, h);
    a.dau[x] = dqn * (h - q) * u * (1.f - u);
    a.dar[x] = grq * q * rr * (1.f - rr);
    a.dqp[x] = dqn * (1.f - u) + grq * rr;
  }
}

struct BwdDqArgs {
  const float* w[5];   // W_h, W_u, U_u, W_r, U_r
  const float* da[5];  // dA_h, dA_u, dA_u, dA_r, dA_r
  const float* dqp;
  const float* extra;  // may be null
  float* dq;
  int d, c;
};

__global__ void __launch_bounds__(5 * GATE_SPLITS * WARP) egcn_bwd_dq_kernel(BwdDqArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);
  const Lane l;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  const int p = l.w / GATE_SPLITS;
  float acc[4][4] = {};
  product<true>(st[l.w], l, a.w[p], a.d, Plain{a.da[p]}, a.c, i0, j0, a.d, a.d,
                Range((a.d + TK - 1) / TK, GATE_SPLITS, l.w % GATE_SPLITS), acc);
  const float* red = gather(smem, acc, l.w, l.rg, l.cg);
  for (int e = threadIdx.x; e < TILE; e += blockDim.x) {
    const int i = i0 + e / TN, j = j0 + e % TN;
    if (i >= a.d || j >= a.c) continue;
    const long long x = static_cast<long long>(i) * a.c + j;
    float v = a.dqp[x];
#pragma unroll
    for (int k = 0; k < 5; ++k) v += part<GATE_SPLITS>(red, k, e);
    if (a.extra != nullptr) v += a.extra[x];
    a.dq[x] = v;
  }
}

struct WgradArgs {
  const float* da[4];  // dA_h, dA_h, dA_u, dA_r: [steps, d, c]
  const float* qin;    // the steps' inputs Q_{t-1}: [steps, d, c]
  const float* r;      // R: [steps, d, c]
  float* out[4];       // dW_h, dU_h, dW_u, dW_r [d, d]
  float* twin[4];      // null, null, dU_u, dU_r: the same sums again
  int steps, d, c;
};

// Step t's columns jc.. of X = Q_{t-1} (or R o Q_{t-1} where rr is given)
// for the output's columns k0.., staged as s.b[jj][kc] = X[t][k0 + kc][jc +
// jj]: a lane loads four columns j of one row k (c a multiple of 4).
__device__ __forceinline__ void fetch_bt(Frag& f, const float* __restrict__ qin,
                                         const float* __restrict__ rr, int t, int jc, int k0,
                                         int d, int c, int lane) {
  const long long base = static_cast<long long>(t) * d * c;
#pragma unroll
  for (int q = 0; q < TK * TN / WARP / 4; ++q) {
    const int e = lane + q * WARP;
    const int kc = e % TN, m = e / TN;
    const int k = k0 + kc, j = jc + 4 * m;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < d && j < c) {
      const long long x = base + static_cast<long long>(k) * c + j;
      v = rr != nullptr ? Prod{rr, qin}.at4(x) : ld4(qin, x);
    }
    f.b[q] = v;
  }
}

__device__ __forceinline__ void put_bt(Stage& s, const Frag& f, int lane) {
#pragma unroll
  for (int q = 0; q < TK * TN / WARP / 4; ++q) {
    const int e = lane + q * WARP;
    const int kc = e % TN, m = e / TN;
    s.b[4 * m][kc] = f.b[q].x;
    s.b[4 * m + 1][kc] = f.b[q].y;
    s.b[4 * m + 2][kc] = f.b[q].z;
    s.b[4 * m + 3][kc] = f.b[q].w;
  }
}

__global__ void __launch_bounds__(ONE_SPLITS * WARP) egcn_wgrad_kernel(WgradArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);
  const Lane l;
  const int prod = blockIdx.z;
  const int i0 = blockIdx.y * TM, k0 = blockIdx.x * TN;  // output rows i, columns k
  const int nj = (a.c + TK - 1) / TK;
  const Range rg(a.steps * nj, ONE_SPLITS, l.w);
  const float* da = a.da[prod];
  const float* rr = prod == 1 ? a.r : nullptr;
  Stage& s = st[l.w];
  float acc[4][4] = {};
  Frag fr;
  auto fetch = [&](int ch) {
    const int t = ch / nj, jc = (ch % nj) * TK;
    fetch_a<false>(fr, da + static_cast<long long>(t) * a.d * a.c, a.c, i0, a.d, jc, a.c,
                   l.lane, true);
    fetch_bt(fr, a.qin, rr, t, jc, k0, a.d, a.c, l.lane);
  };
  if (rg.first < rg.end) fetch(rg.first);
  for (int ch = rg.first; ch < rg.end; ++ch) {
    put_a<false>(s, fr, l.lane, true);
    put_bt(s, fr, l.lane);
    __syncwarp();
    if (ch + 1 < rg.end) fetch(ch + 1);
    mma(s, l.rg, l.cg, acc);
    __syncwarp();
  }
  const float* red = gather(smem, acc, l.w, l.rg, l.cg);
  float* out = a.out[prod];
  float* twin = a.twin[prod];
  for (int e = threadIdx.x; e < TILE; e += blockDim.x) {
    const int i = i0 + e / TN, k = k0 + e % TN;
    if (i >= a.d || k >= a.d) continue;
    const float v = part<ONE_SPLITS>(red, 0, e);
    const long long x = static_cast<long long>(i) * a.d + k;
    out[x] = v;
    if (twin != nullptr) twin[x] = v;
  }
}

__global__ void egcn_bias_sum_kernel(const float* __restrict__ dah, const float* __restrict__ dau,
                                     const float* __restrict__ dar, int steps, long long n,
                                     float* __restrict__ dbh, float* __restrict__ dbu,
                                     float* __restrict__ dbr) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sh = 0.f, su = 0.f, sr = 0.f;
    for (int t = 0; t < steps; ++t) {
      const long long x = t * n + e;
      sh += dah[x];
      su += dau[x];
      sr += dar[x];
    }
    dbh[e] = sh;
    dbu[e] = su;
    dbr[e] = sr;
  }
}

// Launches `kernel` with `warps` warps a block and their shared memory,
// above 48 KB: the attribute is set at a kernel's first launch (before any
// capture: the trainer's first epoch runs eagerly).
template <class K, class A>
int launch(K kernel, bool& ready, dim3 grid, int warps, const A& args, void* stream) {
  const int bytes = smem_bytes(warps);
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  kernel<<<grid, warps * WARP, bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

bool gates_ready = false, update_ready = false, bwd_gate_ready = false, bwd_dq_ready = false,
     wgrad_ready = false;

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

// c a multiple of 4: the [d, c] operands are read four columns at a time
bool shape_ok(int d, int c) { return d > 0 && c > 0 && c % 4 == 0; }

dim3 tiles(int rows, int cols, int z = 1) {
  return dim3((cols + TN - 1) / TN, (rows + TM - 1) / TM, z);
}

template <class T>
const T* f(const void* p) {
  return static_cast<const T*>(p);
}

}  // namespace

extern "C" {

// One step's gates: U, R and P = W_h Q + B_h [d, c] from Q [d, c].
int egcn_gates_launch(const void* wu, const void* uu, const void* wr, const void* ur,
                      const void* wh, const void* bu, const void* br, const void* bh,
                      const void* q, void* u, void* r, void* p, int d, int c, void* stream) {
  if (!shape_ok(d, c) || !wu || !uu || !wr || !ur || !wh || !bu || !br || !bh || !q || !u ||
      !r || !p)
    return invalid();
  GatesArgs a = {{f<float>(wu), f<float>(uu), f<float>(wr), f<float>(ur), f<float>(wh)},
                 f<float>(bu), f<float>(br), f<float>(bh), f<float>(q),
                 static_cast<float*>(u), static_cast<float*>(r), static_cast<float*>(p), d, c};
  return launch(egcn_gates_kernel, gates_ready, tiles(d, c), 5 * GATE_SPLITS, a, stream);
}

// One step's candidate H~ and the evolved weights Q' [d, c].
int egcn_update_launch(const void* uh, const void* q, const void* r, const void* u,
                       const void* p, void* h, void* qn, int d, int c, void* stream) {
  if (!shape_ok(d, c) || !uh || !q || !r || !u || !p || !h || !qn) return invalid();
  UpdateArgs a = {f<float>(uh), f<float>(q), f<float>(r), f<float>(u), f<float>(p),
                  static_cast<float*>(h), static_cast<float*>(qn), d, c};
  return launch(egcn_update_kernel, update_ready, tiles(d, c), ONE_SPLITS, a, stream);
}

// A step's backward, first half: from dQ' the pre-activations' cotangents
// dA_h, dA_u, dA_r and the direct part of dQ (dQ' o (1 - U) + d(R o Q) o R).
int egcn_bwd_gate_launch(const void* uh, const void* dqn, const void* u, const void* h,
                         const void* q, const void* r, void* dah, void* dau, void* dar,
                         void* dqp, int d, int c, void* stream) {
  if (!shape_ok(d, c) || !uh || !dqn || !u || !h || !q || !r || !dah || !dau || !dar || !dqp)
    return invalid();
  BwdGateArgs a = {f<float>(uh), f<float>(dqn), f<float>(u), f<float>(h), f<float>(q),
                   f<float>(r), static_cast<float*>(dah), static_cast<float*>(dau),
                   static_cast<float*>(dar), static_cast<float*>(dqp), d, c};
  return launch(egcn_bwd_gate_kernel, bwd_gate_ready, tiles(d, c), ONE_SPLITS, a, stream);
}

// Its second half: dQ = the direct part + the products through the gates'
// weights, plus `extra` (may be null).
int egcn_bwd_dq_launch(const void* wh, const void* wu, const void* uu, const void* wr,
                       const void* ur, const void* dah, const void* dau, const void* dar,
                       const void* dqp, const void* extra, void* dq, int d, int c,
                       void* stream) {
  if (!shape_ok(d, c) || !wh || !wu || !uu || !wr || !ur || !dah || !dau || !dar || !dqp ||
      !dq)
    return invalid();
  BwdDqArgs a = {{f<float>(wh), f<float>(wu), f<float>(uu), f<float>(wr), f<float>(ur)},
                 {f<float>(dah), f<float>(dau), f<float>(dau), f<float>(dar), f<float>(dar)},
                 f<float>(dqp), f<float>(extra), static_cast<float*>(dq), d, c};
  return launch(egcn_bwd_dq_kernel, bwd_dq_ready, tiles(d, c), 5 * GATE_SPLITS, a, stream);
}

// The weights' gradients over all `steps` at once ([steps, d, c] inputs;
// [d, d] outputs; dW_u and dU_u, dW_r and dU_r written alike).
int egcn_wgrad_launch(const void* dah, const void* dau, const void* dar, const void* qin,
                      const void* r, int steps, int d, int c, void* dwh, void* duh, void* dwu,
                      void* duu, void* dwr, void* dur, void* stream) {
  if (!shape_ok(d, c) || steps <= 0 || !dah || !dau || !dar || !qin || !r || !dwh || !duh ||
      !dwu || !duu || !dwr || !dur)
    return invalid();
  WgradArgs a = {{f<float>(dah), f<float>(dah), f<float>(dau), f<float>(dar)},
                 f<float>(qin),
                 f<float>(r),
                 {static_cast<float*>(dwh), static_cast<float*>(duh), static_cast<float*>(dwu),
                  static_cast<float*>(dwr)},
                 {nullptr, nullptr, static_cast<float*>(duu), static_cast<float*>(dur)},
                 steps,
                 d,
                 c};
  return launch(egcn_wgrad_kernel, wgrad_ready, tiles(d, d, 4), ONE_SPLITS, a, stream);
}

// The biases' gradients: each [d, c] the sum over the steps of its dA.
int egcn_bias_sum_launch(const void* dah, const void* dau, const void* dar, int steps, int d,
                         int c, void* dbh, void* dbu, void* dbr, void* stream) {
  if (!shape_ok(d, c) || steps <= 0 || !dah || !dau || !dar || !dbh || !dbu || !dbr)
    return invalid();
  const long long n = static_cast<long long>(d) * c;
  const int threads = 256;
  const int blocks = static_cast<int>((n + threads - 1) / threads);
  egcn_bias_sum_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      f<float>(dah), f<float>(dau), f<float>(dar), steps, n, static_cast<float*>(dbh),
      static_cast<float*>(dbu), static_cast<float*>(dbr));
  return static_cast<int>(cudaGetLastError());
}

const char* egcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
