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
// The chain's passes, one persistent launch each (egcn_chain_fwd_kernel,
// egcn_chain_bwd_kernel). Every product of a step is a [d, d] matrix times
// a [d, c] one and every other op acts entry by entry, so column strip j of
// Q_t, R o Q, H~, dA_* and dQ_t depends only on strip j of the step
// before, through all the steps, forward and backward: strips never meet.
// A strip of CN = 40 columns is one thread block cluster of ceil(d / 16)
// CTAs of TM = 16 rows (the last one's rows past d masked; columns past c
// zero). 40 and not 32: a CTA's shared memory takes an SM, and the H100
// holds at most 7 clusters of 9 to 16 such CTAs at once (15 of 8), so c =
// 256 has to be 7 strips, or an eighth cluster would run after the rest.
// A CTA keeps its rows of the six weights in shared memory for the whole
// pass, depth-major (forward: rows i0.. of W_u, U_u, W_r, U_r, W_h stacked
// as wg [d][80], of U_h as wu [d][16]; backward: the same rows of the
// transposes, columns of U_h and W_h, of W_u and U_u, of W_r and U_r, three
// [d][32]), and the cluster's whole strip of each operand a product takes
// as B ([d][40]).
//
// A step's stages hand each other a strip: a CTA computes its 16 rows,
// writes them into its own copy and into a staging buffer in global memory,
// and one thread multicasts them from there into every other CTA of the
// cluster (cp.async.bulk ... multicast::cluster: one L2 read for all; the
// SM-to-SM network moved the 40 KB a CTA takes in at ~13 B a cycle, 2,500
// to 5,500 cycles an exchange at d = 256). Each block lands on an mbarrier
// of its own, and a warp waits only for the blocks of its depth range, so
// the products start on the first. Forward step: the gates (the five
// products over Q_t), R o Q to the cluster, the update (U_h (R o Q)), Q_{t+1}
// to the cluster. Backward step, from the last: dA_h (entry by entry) to the
// cluster; U_h^T dA_h and W_h^T dA_h; dA_u, dA_r and dQ's direct part, dA_u
// and dA_r to the cluster; the four products through W_u, U_u, W_r, U_r, and
// dQ_{t-1} = the direct part + the five products + the cotangent of
// Q_{t-1}'s own use, kept in registers (dQ enters the step before entry by
// entry, so it is not exchanged). No barrier across the cluster in the
// loop: a CTA sends a strip's next blocks only after it has every block of
// the other strip of the step, which each CTA sends only once it is done
// reading the first, so no block lands where it is still read. Each step
// writes what the rest of the epoch reads: Q_t, with a gradient to come U,
// R and H~; dA_h, dA_u and dA_r, and dQ_0. No CTA waits on another
// cluster, so clusters that do not fit on the card at once run later.
//
// Inside a CTA, 8 warps. A product splits the depth among the warps, a
// lane holding a register tile: the gates' 80 stacked rows x one half of
// the columns, 10 x 5 a lane, four depth splits (50 multiply-adds per five
// shared-memory reads); the other products R x 5 a lane over 16 or 32 rows.
// The splits' partial sums meet in shared memory, over the strip the
// products have just read (no other CTA writes it before this CTA's next
// send), and are added in a fixed order. Shared memory: forward 96 d +
// max(40 d, 2 x 80 x 44) + max(40 d, 8 x 640) floats, 176 KB at d = 256;
// backward 96 d + max(40 d, 8 x 1280) + max(80 d, 8 x 1280), 216 KB (a block
// may take 227). **Limit**: d <= 256, a cluster of at most 16 CTAs (sm_90's
// non-portable maximum). Past it the wrapper takes the per-step kernels
// below, by shape alone. Bound of a step at d = 256 on 112 SMs: the six
// products' 16 x 40 x 6 x 256 multiply-adds a CTA, 7,680 cycles of an SM's
// 128 FMA lanes (~3.9 us at 1.98 GHz). Measured (H100, clock stamps): ~19,500
// cycles a step at d = 256, ~15,400 at 166: the products at ~55-60% of the
// FMA rate (the lane tiles' shared-memory reads), each exchange's latency
// through the L2 (~1,500-2,000 cycles), the epilogues and the splits' sums.
//
// The per-step kernels (shapes past the limit): one launch a stage, each
// over tiles of 16 x 32 outputs. A block is several warps; each warp
// computes one product of its tile over a fixed range of its depth, chunks
// of 32 staged in the warp's own shared memory (no block barrier in the
// depth loop), a lane 4 x 4 outputs as above. The warps' sums meet in
// shared memory and are added in a fixed order in the epilogue, which also
// applies the gates. No atomics anywhere: two launches on the same inputs
// give the same bits.
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
// Both paths, once after the chain's backward:
//             egcn_wgrad_kernel   the weights' gradients, sums over all
//                                 steps at once (depth steps x c): dW_h =
//                                 sum dA_h Q^T, dU_h = sum dA_h (R o Q)^T,
//                                 dW_u = dU_u = sum dA_u Q^T, dW_r = dU_r =
//                                 sum dA_r Q^T
//             egcn_bias_sum_kernel  dB_* = sum over the steps of dA_*
//
// Numerics: each product sums in f32 with fused multiply-adds, the warps'
// partial sums added in order; the products and the terms added as the
// plain twins add them (W_u Q + U_u Q, never (W_u + U_u) Q); sigmoid as
// 1 / (1 + expf(-x)) and tanhf, as ATen computes them on the card. Only the
// order of the sums differs from cuBLAS's. The forward without a gradient
// to come runs the same code with its stacks' stores off: the same bits.
//
// Plain C interface, loaded with ctypes (kernels/egcn_evolve.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

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

// ---- the persistent chain: one launch a pass, a cluster a column strip ----

constexpr int CN = 40;          // a strip's columns: 7 strips cover c = 256
constexpr int CTILE = TM * CN;  // a CTA's entries of one [d, c] matrix
constexpr int ROW_BYTES = CN * 4;
constexpr int CHAIN_WARPS = 8;
constexpr int CHAIN_THREADS = CHAIN_WARPS * WARP;
constexpr int PER_THREAD = (CTILE + CHAIN_THREADS - 1) / CHAIN_THREADS;  // entries a thread
constexpr int CHAIN_MAX_CTAS = 16;                 // sm_90's largest (non-portable) cluster
constexpr int CHAIN_MAX_D = CHAIN_MAX_CTAS * TM;   // 256
constexpr int GATE_ROWS = 5 * TM;                  // the gates' products stacked: 80 rows
constexpr int SLOT_ROW = CN + 4;                   // a gates slot's row: no bank conflicts
constexpr int GATE_SLOT = GATE_ROWS * SLOT_ROW;
constexpr int GATE_SLOTS = 2 * GATE_SLOT;          // their partial sums, halved twice
constexpr int SPLIT_SLOTS = CHAIN_WARPS * 2 * CTILE;  // a warp's 32 x 40 partial sums each

// Shared memory in floats: the six weights' rows, then two regions each
// holding a strip [d][CN] (the backward's second: two) and, while no other
// CTA writes there, the stages' partial sums.
__host__ __device__ constexpr int at_least(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int fwd_region1(int d) { return at_least(d * CN, GATE_SLOTS); }
__host__ __device__ constexpr int fwd_region2(int d) {
  return at_least(d * CN, CHAIN_WARPS * CTILE);
}
__host__ __device__ constexpr int bwd_region1(int d) { return at_least(d * CN, SPLIT_SLOTS); }
__host__ __device__ constexpr int bwd_region2(int d) { return at_least(2 * d * CN, SPLIT_SLOTS); }
// after the floats, an mbarrier for each block (source CTA) of each exchanged strip
constexpr int BARRIER_BYTES = 3 * CHAIN_MAX_CTAS * 8;
__host__ __device__ constexpr int chain_fwd_bytes(int d) {
  return 4 * (6 * TM * d + fwd_region1(d) + fwd_region2(d)) + BARRIER_BYTES;
}
__host__ __device__ constexpr int chain_bwd_bytes(int d) {
  return 4 * (6 * TM * d + bwd_region1(d) + bwd_region2(d)) + BARRIER_BYTES;
}
static_assert(chain_bwd_bytes(CHAIN_MAX_D) <= 232448 && chain_fwd_bytes(CHAIN_MAX_D) <= 232448,
              "a CTA's shared memory at d = 256");

// ---- the exchange: a block staged in global memory, multicast to the cluster ----

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(bar)) : "memory");
}
// This CTA's arrival for the barrier's current phase, which then completes
// once `bytes` more have landed.
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` from global memory at `src` into the shared memory of every CTA
// of the cluster named in `mask`, at this CTA's offset `dst`, counted there
// on the mbarrier at this CTA's offset `bar`: one read of the L2 for all.
__device__ __forceinline__ void copy_to_all(void* dst, const float* src, unsigned bytes,
                                            unsigned long long* bar, unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ int block_rows(int d, int b) { return min(TM, d - b * TM); }

// A CTA's own block of the cluster's strip at `strip` (its [rows][CN] rows,
// written by its threads there and, as the same [d][CN] layout, at `stage`
// in global memory) to every other CTA of the cluster, counted there on the
// mbarrier of this block, bars[me]; and, where given, the same for strip2.
// Arms this CTA's barriers of the other blocks, which then complete as those
// land (each warp waits for the blocks it reads, so that the products start
// on the first to land). The copies have read the staged blocks before this
// returns, so they may be written again.
__device__ __forceinline__ void send(float* strip, const float* stage, unsigned long long* bars,
                                     float* strip2, const float* stage2,
                                     unsigned long long* bars2, int ctas, int d) {
  asm volatile("fence.proxy.async.global;" ::: "memory");
  __syncthreads();
  const int me = static_cast<int>(blockIdx.x), r = static_cast<int>(threadIdx.x);
  if (r < ctas && r != me) {  // lane r of warp 0: the barrier of block r
    const unsigned in = static_cast<unsigned>(block_rows(d, r) * ROW_BYTES);
    bar_expect(bars + r, in);
    if (strip2 != nullptr) bar_expect(bars2 + r, in);
  }
  if (r == me && ctas > 1) {
    const unsigned short others = static_cast<unsigned short>(((1u << ctas) - 1) & ~(1u << me));
    const unsigned bytes = static_cast<unsigned>(block_rows(d, me) * ROW_BYTES);
    const int at = me * TM * CN;
    copy_to_all(strip + at, stage + at, bytes, bars + me, others);
    if (strip2 != nullptr) copy_to_all(strip2 + at, stage2 + at, bytes, bars2 + me, others);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// Depths [k0, k1) of a product whose strip lands block by block on `bars`
// (null: all here): f(lo, hi) over each block's part once it has landed.
template <class F>
__device__ __forceinline__ void by_block(int k0, int k1, const unsigned long long* bars,
                                         unsigned parity, F f) {
  for (int b = k0 / TM; b * TM < k1; ++b) {
    if (bars != nullptr && b != static_cast<int>(blockIdx.x))
      bar_wait(const_cast<unsigned long long*>(bars + b), parity);
    f(max(k0, b * TM), min(k1, (b + 1) * TM));
  }
}

// ---- the products ----

// Rows i0.. of W_p into dst[k * stride + ii] = W_p[i0 + ii][k], or with TRANS
// W_p[k][i0 + ii] (rows of W_p^T), ii < TM, zero past row d; six such.
struct RowsOf {
  const float* w[6];
  int off[6];  // dst of each, in floats from the weights' base
  int stride[6];
};
template <bool TRANS>
__device__ __forceinline__ void load_rows(float* __restrict__ base, const RowsOf& rs, int i0,
                                          int d) {
  for (int e = threadIdx.x; e < 6 * d; e += blockDim.x) {
    const int p = e / d, k = e % d;
    const float* __restrict__ src = rs.w[p];
    float v[TM];
#pragma unroll
    for (int ii = 0; ii < TM; ++ii) {
      const int i = i0 + ii;
      v[ii] = i < d ? (TRANS ? src[static_cast<long long>(k) * d + i]
                             : src[static_cast<long long>(i) * d + k])
                    : 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(base + rs.off[p] + k * rs.stride[p]);
#pragma unroll
    for (int m = 0; m < TM / 4; ++m)
      dst[m] = make_float4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The gates' products stacked, A = wg [d][80] (W_u, U_u, W_r, U_r, W_h: 16
// rows each) times the strip B [d][CN], over depths [k0, k1), one half of
// the columns (h): a lane's 10 x 5 outputs, rows 8 rg .. 8 rg + 7 and
// 64 + 2 rg, + 1 (rg < 8), columns 16 h + 4 cg .. + 3 and 32 + 4 h + cg
// (cg < 4): 50 multiply-adds per five shared-memory reads.
__device__ __forceinline__ int gate_row(int rg, int i) {
  return i < 8 ? 8 * rg + i : 64 + 2 * rg + i - 8;
}

__device__ __forceinline__ void mac_gates(const float* __restrict__ A, const float* __restrict__ B,
                                          int k0, int k1, int rg, int cg, int h,
                                          float (&acc)[10][5]) {
  const float* a = A + 8 * rg;
  const float* a2 = A + 64 + 2 * rg;
  const float* b = B + 16 * h + 4 * cg;
  const float* b1 = B + 32 + 4 * h + cg;
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    const float4 a0 = lds4(a + k * GATE_ROWS), a1 = lds4(a + k * GATE_ROWS + 4);
    const float2 a3 = lds2(a2 + k * GATE_ROWS);
    const float4 b0 = lds4(b + k * CN);
    const float x[10] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a3.x, a3.y};
    const float y[5] = {b0.x, b0.y, b0.z, b0.w, b1[k * CN]};
#pragma unroll
    for (int i = 0; i < 10; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// A gates slot's row of stacked row R (= 8 rg + i or 64 + 2 rg + i - 8):
// a lane's eight first rows interleaved with the next lane group's, so that
// a quarter warp writes rows SLOT_ROW apart, on other banks.
__host__ __device__ __forceinline__ int slot_row(int R) {
  return R < 64 ? (R % 8) * 8 + R / 8 : R;
}

// A lane's 10 x 5 tile into (ADD: onto) a [80][SLOT_ROW] slot.
template <bool ADD>
__device__ __forceinline__ void tile_gates(float* slot, float (&acc)[10][5], int rg, int cg,
                                           int h) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    float* r = slot + slot_row(gate_row(rg, i)) * SLOT_ROW;
    float4* c0 = reinterpret_cast<float4*>(r + 16 * h + 4 * cg);
    float* c1 = r + 32 + 4 * h + cg;
    if (ADD) {
      const float4 v = *c0;
      acc[i][0] += v.x;
      acc[i][1] += v.y;
      acc[i][2] += v.z;
      acc[i][3] += v.w;
      acc[i][4] += *c1;
    } else {
      *c0 = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *c1 = acc[i][4];
    }
  }
}

// The gates' four depth splits s of each column half h (warp 4 h + s),
// summed in halves: slot 0 and slot 1 end up holding (s0 + s2) and (s1 +
// s3) (every thread calls it; the first barrier so that the slots may
// overlay the strip just read).
__device__ __forceinline__ void reduce_gates(float* slots, float (&acc)[10][5], int s, int rg,
                                             int cg, int h) {
  __syncthreads();
  if (s >= 2) tile_gates<false>(slots + (s - 2) * GATE_SLOT, acc, rg, cg, h);
  __syncthreads();
  if (s < 2) {
    tile_gates<true>(slots + s * GATE_SLOT, acc, rg, cg, h);
    tile_gates<false>(slots + s * GATE_SLOT, acc, rg, cg, h);
  }
  __syncthreads();
}

// A product with a tile of R = 4 or 8 rows (A [d][4 R] of R-row groups, 4
// of them: 16 or 32 rows) times the strip B [d][CN], over depths [k0, k1):
// a lane's R x 5 outputs, rows R rg .. R rg + R - 1 (rg < 4), columns 4 cg ..
// 4 cg + 3 and 32 + cg (cg < 8).
template <int R>
__device__ __forceinline__ void mac_rows(const float* __restrict__ A, const float* __restrict__ B,
                                         int k0, int k1, int rg, int cg, float (&acc)[R][5]) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float* a = A + k * 4 * R + R * rg;
    const float* b = B + k * CN;
    float x[R];
#pragma unroll
    for (int m = 0; m < R / 4; ++m) {
      const float4 v = lds4(a + 4 * m);
      x[4 * m] = v.x;
      x[4 * m + 1] = v.y;
      x[4 * m + 2] = v.z;
      x[4 * m + 3] = v.w;
    }
    const float4 b0 = lds4(b + 4 * cg);
    const float y[5] = {b0.x, b0.y, b0.z, b0.w, b[32 + cg]};
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// A warp's R x 5 lane tiles, its [4 R][CN] partial sums, into `slot`.
template <int R>
__device__ __forceinline__ void tile_rows(float* slot, const float (&acc)[R][5], int rg, int cg) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float* r = slot + (R * rg + i) * CN;
    *reinterpret_cast<float4*>(r + 4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    r[32 + cg] = acc[i][4];
  }
}

// Split s of S over the depth d: [k0, k1).
__device__ __forceinline__ void split(int d, int S, int s, int& k0, int& k1) {
  const int per = (d + S - 1) / S;
  k0 = min(d, s * per);
  k1 = min(d, k0 + per);
}

// Entry `at` of the S slots from `first` (each `size` floats), added in
// order.
__device__ __forceinline__ float sum_slots(const float* slots, int first, int S, int size,
                                           int at) {
  float v = slots[first * size + at];
  for (int s = 1; s < S; ++s) v += slots[(first + s) * size + at];
  return v;
}

// The entries a thread holds in the epilogues: e = tid + 256 m of the
// CTA's 16 x 40 (m < PER_THREAD).
struct Entries {
  int e[PER_THREAD];     // index in the tile
  bool row[PER_THREAD];  // a row of Q (i < d)
  bool own[PER_THREAD];  // and a column of it (j < c): an entry the pass writes
  long long x[PER_THREAD];  // index in a [d, c] matrix
  __device__ Entries(int d, int c) {
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      e[m] = threadIdx.x + m * CHAIN_THREADS;
      const int i = blockIdx.x * TM + e[m] / CN, j = blockIdx.y * CN + e[m] % CN;
      row[m] = e[m] < CTILE && i < d;
      own[m] = row[m] && j < c;
      x[m] = static_cast<long long>(i) * c + j;
    }
  }
};

struct ChainFwdArgs {
  RowsOf w;   // W_u, U_u, W_r, U_r, W_h into wg [d][80]; U_h into wu [d][16]
  const float* bu;
  const float* br;
  const float* bh;
  const float* q0;
  float* qs;  // [steps + 1, d, c]: Q_0 .. Q_steps
  float* us;  // [steps, d, c] each, or all three null (no gradient to come)
  float* rs;
  float* hs;
  float* stage;  // [2, strips, d, CN]: each CTA's rows of Q_t and of R o Q_t for the others
  int steps, d, c;
};

__global__ void __launch_bounds__(CHAIN_THREADS, 1) egcn_chain_fwd_kernel(ChainFwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int d = a.d, c = a.c, ctas = gridDim.x, i0 = blockIdx.x * TM, j0 = blockIdx.y * CN;
  float* wg = reinterpret_cast<float*>(smem);  // [d][80]
  float* wu = wg + GATE_ROWS * d;               // [d][16]
  float* qst = wu + TM * d;                     // Q_t's strip; the gates' slots
  float* rqs = qst + fwd_region1(d);            // (R o Q_t)'s strip; the update's slots
  unsigned long long* bar_q = reinterpret_cast<unsigned long long*>(rqs + fwd_region2(d));
  unsigned long long* bar_rq = bar_q + CHAIN_MAX_CTAS;
  const long long strip_floats = static_cast<long long>(d) * CN;
  float* stq = a.stage + blockIdx.y * strip_floats;       // Q_t's strip, staged
  float* strq = stq + gridDim.y * strip_floats;          // (R o Q_t)'s
  if (threadIdx.x == 0) {
    for (int b = 0; b < ctas; ++b) {
      bar_init(bar_q + b);
      bar_init(bar_rq + b);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  load_rows<false>(wg, a.w, i0, d);
  for (int e = threadIdx.x; e < d * CN; e += blockDim.x) {
    const int j = j0 + e % CN;
    qst[e] = j < c ? a.q0[static_cast<long long>(e / CN) * c + j] : 0.f;
  }
  const Entries en(d, c);
  const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long dc = static_cast<long long>(d) * c;
  // an entry's Q_t, and its biases, the same every step
  float q[PER_THREAD], bu[PER_THREAD], br[PER_THREAD], bh[PER_THREAD];
#pragma unroll
  for (int m = 0; m < PER_THREAD; ++m) {
    q[m] = bu[m] = br[m] = bh[m] = 0.f;
    if (en.own[m]) {
      q[m] = a.q0[en.x[m]];
      bu[m] = a.bu[en.x[m]];
      br[m] = a.br[en.x[m]];
      bh[m] = a.bh[en.x[m]];
      a.qs[en.x[m]] = q[m];
    }
  }
  cl.sync();  // every CTA of the cluster runs, its barriers set and Q_0's strip loaded
  int k0, k1, g0, g1;
  split(d, CHAIN_WARPS, w, k0, k1);
  split(d, 4, w % 4, g0, g1);  // the gates': four depth splits of each column half
  for (int t = 0; t < a.steps; ++t) {
    {  // the gates: the five stacked products, two column halves x four depth splits
      float acc[10][5] = {};
      by_block(g0, g1, t > 0 ? bar_q : nullptr, (t - 1) & 1, [&](int lo, int hi) {
        mac_gates(wg, qst, lo, hi, lane / 4, lane % 4, w / 4, acc);
      });
      reduce_gates(qst, acc, w % 4, lane / 4, lane % 4, w / 4);
    }
    float u[PER_THREAD], ph[PER_THREAD];
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      u[m] = ph[m] = 0.f;
      if (!en.row[m]) continue;
      float r = 0.f;
      if (en.own[m]) {
        const int ii = en.e[m] / CN, jj = en.e[m] % CN;
        float z[5];
#pragma unroll
        for (int p = 0; p < 5; ++p) {
          const int at = slot_row(p * TM + ii) * SLOT_ROW + jj;
          z[p] = qst[at] + qst[GATE_SLOT + at];
        }
        u[m] = sigmoid_f(z[0] + z[1] + bu[m]);
        r = sigmoid_f(z[2] + z[3] + br[m]);
        ph[m] = z[4] + bh[m];
        if (a.us != nullptr) {
          a.us[t * dc + en.x[m]] = u[m];
          a.rs[t * dc + en.x[m]] = r;
        }
      }
      rqs[i0 * CN + en.e[m]] = strq[i0 * CN + en.e[m]] = r * q[m];
    }
    send(rqs, strq, bar_rq, nullptr, nullptr, nullptr, ctas, d);
    {  // the update: U_h (R o Q), eight depth splits, a warp's partial sums a slot
      float acc[4][5] = {};
      by_block(k0, k1, bar_rq, t & 1, [&](int lo, int hi) {
        mac_rows<4>(wu, rqs, lo, hi, lane / 8, lane % 8, acc);
      });
      __syncthreads();
      tile_rows<4>(rqs + w * CTILE, acc, lane / 8, lane % 8);
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      if (!en.row[m]) continue;
      float qn = 0.f;
      if (en.own[m]) {
        const float h = tanhf(ph[m] + sum_slots(rqs, 0, CHAIN_WARPS, CTILE, en.e[m]));
        qn = (1.f - u[m]) * q[m] + u[m] * h;
        a.qs[(t + 1) * dc + en.x[m]] = qn;
        if (a.hs != nullptr) a.hs[t * dc + en.x[m]] = h;
      }
      qst[i0 * CN + en.e[m]] = stq[i0 * CN + en.e[m]] = qn;
      q[m] = qn;
    }
    if (t + 1 < a.steps) send(qst, stq, bar_q, nullptr, nullptr, nullptr, ctas, d);
  }
  cl.sync();  // no CTA leaves while a copy may still reach it
}

struct ChainBwdArgs {
  RowsOf w;         // rows of U_h^T, W_h^T into wb1 [d][32]; W_u^T, U_u^T into wb2;
                    // W_r^T, U_r^T into wb3
  const float* g;   // [steps, d, c]: the cotangents of Q_1 .. Q_steps
  const float* qs;  // step t's input Q_t at [t] (t < steps)
  const float* us;  // [steps, d, c]: U, R, H~ of each step
  const float* rs;
  const float* hs;
  float* dah;  // [steps, d, c]
  float* dau;
  float* dar;
  float* dq0;  // [d, c]
  float* stage;  // [3, strips, d, CN]: each CTA's rows of dA_h, dA_u, dA_r for the others
  int steps, d, c;
};

__global__ void __launch_bounds__(CHAIN_THREADS, 1) egcn_chain_bwd_kernel(ChainBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int d = a.d, c = a.c, ctas = gridDim.x, i0 = blockIdx.x * TM;
  float* wb = reinterpret_cast<float*>(smem);  // wb1, wb2, wb3 [d][32] each
  float* dhs = wb + 6 * TM * d;                 // dA_h's strip; the first products' slots
  float* dus = dhs + bwd_region1(d);            // dA_u's strip, then dA_r's; the
  float* drs = dus + d * CN;                    //   last products' slots over both
  unsigned long long* bar_h = reinterpret_cast<unsigned long long*>(dus + bwd_region2(d));
  unsigned long long* bar_u = bar_h + CHAIN_MAX_CTAS;
  unsigned long long* bar_r = bar_u + CHAIN_MAX_CTAS;
  const long long strip_floats = static_cast<long long>(d) * CN;
  float* sth = a.stage + blockIdx.y * strip_floats;  // dA_h's strip, staged
  float* stu = sth + gridDim.y * strip_floats;       // dA_u's
  float* str = stu + gridDim.y * strip_floats;       // dA_r's
  constexpr int PART = 2 * CTILE;  // a warp's [32][CN] partial sums
  if (threadIdx.x == 0) {
    for (int b = 0; b < ctas; ++b) {
      bar_init(bar_h + b);
      bar_init(bar_u + b);
      bar_init(bar_r + b);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  load_rows<true>(wb, a.w, i0, d);
  const Entries en(d, c);
  const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long dc = static_cast<long long>(d) * c;
  const int last = a.steps - 1;
  // an entry's dQ' at the step at hand, and its U, H~, Q, R fetched a step ahead
  float dqn[PER_THREAD], nu[PER_THREAD], nh[PER_THREAD], nq[PER_THREAD], nr[PER_THREAD];
#pragma unroll
  for (int m = 0; m < PER_THREAD; ++m) {
    dqn[m] = nu[m] = nh[m] = nq[m] = nr[m] = 0.f;
    if (en.own[m]) {
      const long long y = last * dc + en.x[m];
      dqn[m] = a.g[y];
      nu[m] = a.us[y];
      nh[m] = a.hs[y];
      nq[m] = a.qs[y];
      nr[m] = a.rs[y];
    }
  }
  cl.sync();  // every CTA of the cluster runs, its barriers set
  int k0, k1, k2, k3;
  split(d, CHAIN_WARPS, w, k0, k1);
  split(d, 4, w % 4, k2, k3);
  const int half = w / 4;  // the last products: W_u^T, U_u^T (0) or W_r^T, U_r^T (1)
  for (int t = last; t >= 0; --t) {
    const unsigned parity = (last - t) & 1;
    float u[PER_THREAD], h[PER_THREAD], q[PER_THREAD], r[PER_THREAD], extra[PER_THREAD];
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      u[m] = nu[m];
      h[m] = nh[m];
      q[m] = nq[m];
      r[m] = nr[m];
      extra[m] = 0.f;  // the cotangent of Q_t's own use (an output when t > 0)
      if (en.own[m] && t > 0) {
        const long long y = (t - 1) * dc + en.x[m];
        extra[m] = a.g[y];
        nu[m] = a.us[y];
        nh[m] = a.hs[y];
        nq[m] = a.qs[y];
        nr[m] = a.rs[y];
      }
      if (!en.row[m]) continue;
      float dh = 0.f;
      if (en.own[m]) {
        dh = dah_of(dqn[m], u[m], h[m]);
        a.dah[t * dc + en.x[m]] = dh;
      }
      dhs[i0 * CN + en.e[m]] = sth[i0 * CN + en.e[m]] = dh;
    }
    send(dhs, sth, bar_h, nullptr, nullptr, nullptr, ctas, d);
    {  // U_h^T dA_h (rows 0-15) and W_h^T dA_h (16-31), eight depth splits
      float acc[8][5] = {};
      by_block(k0, k1, bar_h, parity, [&](int lo, int hi) {
        mac_rows<8>(wb, dhs, lo, hi, lane / 8, lane % 8, acc);
      });
      __syncthreads();
      tile_rows<8>(dhs + w * PART, acc, lane / 8, lane % 8);
      __syncthreads();
    }
    float dqp[PER_THREAD], whp[PER_THREAD];
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      dqp[m] = whp[m] = 0.f;
      if (!en.row[m]) continue;
      float du = 0.f, dr = 0.f;
      if (en.own[m]) {
        const float grq = sum_slots(dhs, 0, CHAIN_WARPS, PART, en.e[m]);  // d(R o Q)
        whp[m] = sum_slots(dhs, 0, CHAIN_WARPS, PART, CTILE + en.e[m]);
        const float g = dqn[m];
        du = g * (h[m] - q[m]) * u[m] * (1.f - u[m]);
        dr = grq * q[m] * r[m] * (1.f - r[m]);
        dqp[m] = g * (1.f - u[m]) + grq * r[m];
        a.dau[t * dc + en.x[m]] = du;
        a.dar[t * dc + en.x[m]] = dr;
      }
      dus[i0 * CN + en.e[m]] = stu[i0 * CN + en.e[m]] = du;
      drs[i0 * CN + en.e[m]] = str[i0 * CN + en.e[m]] = dr;
    }
    send(dus, stu, bar_u, drs, str, bar_r, ctas, d);
    {  // W_u^T dA_u, U_u^T dA_u (warps 0-3), W_r^T dA_r, U_r^T dA_r (4-7), four
       // depth splits each
      float acc[8][5] = {};
      const float* A = wb + (1 + half) * 2 * TM * d;
      const float* B = half == 0 ? dus : drs;
      by_block(k2, k3, half == 0 ? bar_u : bar_r, parity, [&](int lo, int hi) {
        mac_rows<8>(A, B, lo, hi, lane / 8, lane % 8, acc);
      });
      __syncthreads();
      tile_rows<8>(dus + w * PART, acc, lane / 8, lane % 8);
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      if (!en.own[m]) continue;
      const int at = en.e[m];
      float v = dqp[m];
      v += whp[m];
      v += sum_slots(dus, 0, 4, PART, at);
      v += sum_slots(dus, 0, 4, PART, CTILE + at);
      v += sum_slots(dus, 4, 4, PART, at);
      v += sum_slots(dus, 4, 4, PART, CTILE + at);
      if (t > 0) v += extra[m];
      dqn[m] = v;
    }
  }
#pragma unroll
  for (int m = 0; m < PER_THREAD; ++m)
    if (en.own[m]) a.dq0[en.x[m]] = dqn[m];
  cl.sync();  // no CTA leaves while a copy may still reach it
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

// Launches a pass of the chain: a cluster of `ctas` CTAs for each of
// `strips` column strips. The shared-memory size (the largest d's) and
// the non-portable cluster size are allowed at a kernel's first launch,
// before any capture.
template <class K, class A>
int launch_chain(K kernel, bool& ready, int max_bytes, int ctas, int strips, int bytes,
                 const A& args, void* stream) {
  if (!ready) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, strips, 1);
  cfg.blockDim = dim3(CHAIN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool chain_fwd_ready = false, chain_bwd_ready = false;

// the persistent chain's shapes: a cluster of at most CHAIN_MAX_CTAS
bool chain_ok(int d, int c, int steps) {
  return d > 0 && d <= CHAIN_MAX_D && c > 0 && c % 4 == 0 && steps > 0;
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

// The chain's forward over `steps` steps, one launch: Q_0 .. Q_steps into
// qs [steps + 1, d, c]; with us, rs, hs (all three, or none) each step's
// U, R and H~ [steps, d, c]. d <= 256.
int egcn_chain_fwd_launch(const void* wu, const void* uu, const void* wr, const void* ur,
                          const void* wh, const void* uh, const void* bu, const void* br,
                          const void* bh, const void* q0, void* qs, void* us, void* rs,
                          void* hs, void* stage, int steps, int d, int c, void* stream) {
  const bool keep = us != nullptr;
  if (!chain_ok(d, c, steps) || !wu || !uu || !wr || !ur || !wh || !uh || !bu || !br || !bh ||
      !q0 || !qs || !stage || (rs != nullptr) != keep || (hs != nullptr) != keep)
    return invalid();
  ChainFwdArgs a = {{{f<float>(wu), f<float>(uu), f<float>(wr), f<float>(ur), f<float>(wh),
                      f<float>(uh)},
                     {0, TM, 2 * TM, 3 * TM, 4 * TM, GATE_ROWS * d},
                     {GATE_ROWS, GATE_ROWS, GATE_ROWS, GATE_ROWS, GATE_ROWS, TM}},
                    f<float>(bu), f<float>(br), f<float>(bh), f<float>(q0),
                    static_cast<float*>(qs), static_cast<float*>(us), static_cast<float*>(rs),
                    static_cast<float*>(hs), static_cast<float*>(stage), steps, d, c};
  return launch_chain(egcn_chain_fwd_kernel, chain_fwd_ready, chain_fwd_bytes(CHAIN_MAX_D),
                      (d + TM - 1) / TM, (c + CN - 1) / CN, chain_fwd_bytes(d), a, stream);
}

// The chain's backward through time, one launch: from the cotangents g
// [steps, d, c] of Q_1 .. Q_steps and the forward's qs, U, R, H~, every
// step's dA_h, dA_u, dA_r [steps, d, c] and Q_0's cotangent dq0 [d, c].
int egcn_chain_bwd_launch(const void* uh, const void* wh, const void* wu, const void* uu,
                          const void* wr, const void* ur, const void* g, const void* qs,
                          const void* us, const void* rs, const void* hs, void* dah, void* dau,
                          void* dar, void* dq0, void* stage, int steps, int d, int c,
                          void* stream) {
  if (!chain_ok(d, c, steps) || !uh || !wh || !wu || !uu || !wr || !ur || !g || !qs || !us ||
      !rs || !hs || !dah || !dau || !dar || !dq0 || !stage)
    return invalid();
  ChainBwdArgs a = {{{f<float>(uh), f<float>(wh), f<float>(wu), f<float>(uu), f<float>(wr),
                      f<float>(ur)},
                     {0, TM, 2 * TM * d, 2 * TM * d + TM, 4 * TM * d, 4 * TM * d + TM},
                     {2 * TM, 2 * TM, 2 * TM, 2 * TM, 2 * TM, 2 * TM}},
                    f<float>(g), f<float>(qs), f<float>(us), f<float>(rs), f<float>(hs),
                    static_cast<float*>(dah), static_cast<float*>(dau),
                    static_cast<float*>(dar), static_cast<float*>(dq0),
                    static_cast<float*>(stage), steps, d, c};
  return launch_chain(egcn_chain_bwd_kernel, chain_bwd_ready, chain_bwd_bytes(CHAIN_MAX_D),
                      (d + TM - 1) / TM, (c + CN - 1) / CN, chain_bwd_bytes(d), a, stream);
}

// The floats of one exchanged matrix's staging buffer, [ceil(c / 40), d, 40]:
// a forward pass takes two, a backward three.
long long egcn_chain_stage_floats(int d, int c) {
  return static_cast<long long>((c + CN - 1) / CN) * d * CN;
}

const char* egcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
