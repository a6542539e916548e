// Shared by bsda_spmm.cu and gat_fwd.cu: what both do per destination
// chunk of the BSDA tables. Find the chunk's edges in its bit-packed
// planes, list them in shared memory, fetch one row segment of a dense
// array per edge into shared memory with asynchronous copies, and hand
// every destination row's edges, in a fixed order, to the one thread group
// that owns the row.
//
// Table layout (kernels/bsda.py): a [B, planes, 128, 128] bytes. With
// pack 1 a byte is the multiplicity of slot d = plane; with pack 2 or 4 a
// byte holds `pack` slots of 8 / pack bits each, slot d in plane d / pack
// at bit offset (8 / pack) * (d % pack). a[b, d, i, j] is the multiplicity
// of edge (src_chunk[b, d] * 128 + j) -> (b * 128 + i). The planes are
// >99% zeros at Elliptic scale: a chunk of 128 rows holds a few hundred
// edges.
//
// A block of 256 threads serves one chunk. Building the list is bound by
// warp instructions and barriers, not bytes (the planes are a fifth of the
// traffic), so every row costs a few instructions and only what is nonzero
// is looked at twice:
//  1. count_rows: warp w reads the plane words of rows 16w..16w+15 straight
//     from global memory, one word a lane, sixteen independent coalesced
//     loads in flight a lane (the planes are not staged: fill_items reads
//     them again from L1/L2, which costs less than the registers or the
//     shared memory to keep them), and counts per row the nonzero words
//     (the items) and the edges. One barrier turns the counts into offsets.
//  2. fill_items: a ballot per row gives every item its place, in (row,
//     plane, word) order.
//  3. expand_items: one thread an item. From the other items of its row it
//     finds where its edges go, so that the row's edges lie in increasing
//     (slot, j) order: the order of the f32 sums. An edge is one word,
//     source row and multiplicity.
//  4. gather: per edge, the source row's segment by cp.async of 16, 8 or 4
//     bytes (what the rows' alignment allows; for bf16 rows of odd length,
//     4-byte copies from the aligned address below, the segment then lying
//     0 or 2 bytes into its slot), every copy of a batch in flight at once.
//  5. walk_rows: a thread group owns a row and sums its edges from shared
//     memory in list order.
// A list holds `list_cap` edges (at least one whole row's worst case, 128 *
// depth); a chunk with more is taken in groups of whole rows. A gather
// buffer holds `batch` edges; the batches of a group are fetched two
// buffers deep (edges that fit both buffers together are one batch), and a
// row whose edges straddle two batches carries its partial sums in
// registers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bsda {

constexpr int kChunk = 128;                    // BsdaGraph.chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kChunk / kWarps;  // 16
constexpr int kPlaneBytes = kChunk * kChunk;   // 16 KB
constexpr int kPlaneWords = kPlaneBytes / 4;
constexpr int kRowWords = kChunk / 4;          // 32: one word a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinListCap = 2048;              // edges; a mean chunk holds ~260
// One gather buffer. Two of them, the list and 64 registers a thread let an
// SM hold four blocks; 12 and 24 KB, and five or six blocks of fewer
// registers, were slower at the launch shapes of the configs.
constexpr int kBufBytes = 20480;
constexpr int kMaxBatch = 512;                 // edges a buffer holds at most
constexpr int kMinBlocks = 4;                  // blocks an SM should hold (caps registers)
constexpr int kMaxSmem = 232448;               // a block's shared memory on sm_90

// ---------------- asynchronous copies ----------------

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                 "n"(N)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------- the edge list ----------------

constexpr uint32_t kRowMask = 0x00ffffffu;  // an edge: source row | multiplicity << 24
constexpr int kMaxRows = 1 << 24;           // rows the dense array may have
constexpr int kMaxDepth = 256;              // an item keeps its plane in 8 bits

struct EdgeList {
  uint32_t* edge;  // [list_cap] the group's edges
  int* item_off;   // [129] items of row i: [item_off[i], item_off[i + 1]) of the chunk
  int* edge_off;   // [129] the same for edges
  int* scratch;    // [16]
  int32_t* src_chunk;  // [depth] the chunk's row of src_chunk
  // the items, nonzero plane words in (row, plane, word) order: they lie in
  // the gather buffers, which are idle until the list is built
  uint32_t* item_w;     // [list_cap] the word
  uint32_t* item_meta;  // [list_cap] row << 13 | plane << 5 | word
};

__host__ __device__ inline int list_cap_for(int depth) {
  return depth * kChunk > kMinListCap ? depth * kChunk : kMinListCap;
}

// Shared memory of the list proper, and of its items (inside the buffers).
__host__ __device__ inline size_t list_bytes(int list_cap, int depth) {
  return (size_t)list_cap * 4 + (2 * (kChunk + 1) + 16 + 2 + (depth + 3) / 4 * 4) * 4;
}
__host__ __device__ inline size_t item_bytes(int list_cap) { return (size_t)list_cap * 8; }

// Edges a gather buffer holds: what fits kBufBytes, at most kMaxBatch.
inline int batch_for(int stride) {
  const int fit = kBufBytes / stride;
  return fit < kMaxBatch ? fit : kMaxBatch;
}

// Bytes of the two gather buffers, at least what the items need.
inline int buffer_area(int batch, int stride, int list_cap) {
  const size_t bufs = 2 * (size_t)batch * stride;
  const size_t area = bufs > item_bytes(list_cap) ? bufs : item_bytes(list_cap);
  return static_cast<int>((area + 15) / 16 * 16);
}

// Carves the list out of shared memory at `p`, its items at `items`.
__device__ __forceinline__ EdgeList make_list(unsigned char* p, unsigned char* items,
                                              int list_cap) {
  EdgeList ed;
  ed.edge = reinterpret_cast<uint32_t*>(p);
  ed.item_off = reinterpret_cast<int*>(ed.edge + list_cap);
  ed.edge_off = ed.item_off + kChunk + 1;
  ed.scratch = ed.edge_off + kChunk + 1;
  ed.src_chunk = ed.scratch + 16;
  ed.item_w = reinterpret_cast<uint32_t*>(items);
  ed.item_meta = ed.item_w + list_cap;
  return ed;
}

// Number of nonzero `bits`-wide fields of a word (bits 2, 4 or 8).
__device__ __forceinline__ int nonzero_fields(uint32_t w, int bits) {
  if (bits >= 8) w |= w >> 4;
  if (bits >= 4) w |= w >> 2;
  w |= w >> 1;
  w &= bits >= 8 ? 0x01010101u : bits >= 4 ? 0x11111111u : 0x55555555u;
  return __popc(w);
}

// Per slot of a plane word, the number of bytes that hold an edge of the
// slot: `pack` counts of 0..4, slot sl's in byte sl.
__device__ __forceinline__ uint32_t slot_counts(uint32_t w, int pack) {
  const int bits = 8 / pack;
  const uint32_t field_mask = ((1u << bits) - 1u) * 0x01010101u;
  uint32_t c = 0u;
#pragma unroll
  for (int sl = 0; sl < 4; ++sl)
    if (sl < pack) c |= (uint32_t)nonzero_fields((w >> (bits * sl)) & field_mask, 8) << (8 * sl);
  return c;
}

// The words of rows 16 * warp .. + 15 of one plane, one word a lane.
__device__ __forceinline__ void load_row_words(uint32_t (&w)[kRowsPerWarp],
                                               const uint32_t* plane, int warp,
                                               int lane) {
  const uint32_t* p = plane + warp * kRowsPerWarp * kRowWords + lane;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) w[r] = __ldg(p + r * kRowWords);
}

// What count_rows leaves in every thread.
struct ChunkCounts {
  int items, edges;  // of the whole chunk
  int item_start;    // lane r < 16: items of the chunk before row 16 * warp + r
};

// Counts per row of the chunk's first n_planes planes the items (nonzero
// words) and the edges (nonzero fields), and fills ed.item_off and
// ed.edge_off. Also brings the chunk's row of src_chunk into the list.
// Every thread of the block calls this; the offsets are there for every
// thread after the next block barrier, a warp's own item_start at once.
__device__ __forceinline__ ChunkCounts count_rows(const uint32_t* planes_b, int n_planes,
                                                  int pack, const int32_t* src_chunk_b,
                                                  int depth, const EdgeList& ed) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bits = 8 / pack;
  if ((int)threadIdx.x < depth) ed.src_chunk[threadIdx.x] = __ldg(src_chunk_b + threadIdx.x);
  int items = 0, edges = 0;  // lane r < 16: of row 16 * warp + r
  for (int p = 0; p < n_planes; ++p) {
    uint32_t w[kRowsPerWarp];
    load_row_words(w, planes_b + (size_t)p * kPlaneWords, warp, lane);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const unsigned nz = __ballot_sync(kFull, w[r] != 0u);
      if (nz == 0u) continue;
      const int t = __reduce_add_sync(kFull, nonzero_fields(w[r], bits));
      if (lane == r) {
        items += __popc(nz);
        edges += t;
      }
    }
  }
  int items_incl = items, edges_incl = edges;  // over the warp's rows (lanes 16.. hold zeros)
#pragma unroll
  for (int o = 1; o < kRowsPerWarp; o <<= 1) {
    const int ti = __shfl_up_sync(kFull, items_incl, o);
    const int te = __shfl_up_sync(kFull, edges_incl, o);
    if (lane >= o) {
      items_incl += ti;
      edges_incl += te;
    }
  }
  if (lane == kRowsPerWarp - 1) {
    ed.scratch[warp] = items_incl;
    ed.scratch[kWarps + warp] = edges_incl;
  }
  __syncthreads();
  ChunkCounts total = {0, 0, 0};
  int items_before = 0, edges_before = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int ti = ed.scratch[k], te = ed.scratch[kWarps + k];
    if (k < warp) {
      items_before += ti;
      edges_before += te;
    }
    total.items += ti;
    total.edges += te;
  }
  if (lane < kRowsPerWarp) {
    ed.item_off[1 + warp * kRowsPerWarp + lane] = items_before + items_incl;
    ed.edge_off[1 + warp * kRowsPerWarp + lane] = edges_before + edges_incl;
  }
  if (threadIdx.x == 0) ed.item_off[0] = ed.edge_off[0] = 0;
  total.item_start = items_before + items_incl - items;
  return total;
}

// The end r1 of the group of whole rows that starts at r0 and fits the
// list: the largest r1 with edge_off[r1] - edge_off[r0] <= list_cap. One
// row always fits (list_cap >= 128 * depth). The same value in every thread.
__device__ __forceinline__ int group_end(const int* edge_off, int r0, int list_cap) {
  const int base = edge_off[r0];
  if (edge_off[kChunk] - base <= list_cap) return kChunk;
  int lo = r0 + 1, hi = kChunk;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (edge_off[mid] - base <= list_cap) lo = mid; else hi = mid;
  }
  return lo;
}

// Writes the items of rows [r0, r1), row i's at item_off[i] - item_off[r0]
// onward, in increasing (plane, word) order; `run` is that place for row
// 16 * warp + lane (count_rows's item_start less item_off[r0]). Every
// thread of the block calls this; the caller puts a block barrier after.
__device__ __forceinline__ void fill_items(const uint32_t* planes_b, int n_planes,
                                           const EdgeList& ed, int r0, int r1, int run) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = warp * kRowsPerWarp;
  if (first >= r1 || first + kRowsPerWarp <= r0) return;  // the warp as one
  const uint32_t below = (1u << lane) - 1u;
  for (int p = 0; p < n_planes; ++p) {
    uint32_t w[kRowsPerWarp];
    load_row_words(w, planes_b + (size_t)p * kPlaneWords, warp, lane);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = first + r;
      if (i < r0 || i >= r1) continue;
      const unsigned nz = __ballot_sync(kFull, w[r] != 0u);
      if (nz == 0u) continue;
      const int pos = __shfl_sync(kFull, run, r);
      if (w[r] != 0u) {
        const int at = pos + __popc(nz & below);
        ed.item_w[at] = w[r];
        ed.item_meta[at] = (uint32_t)(i << 13 | p << 5 | lane);
      }
      if (lane == r) run = pos + __popc(nz);
    }
  }
}

// Expands the group's n_items items (rows [r0, r1)) into ed.edge, one
// thread an item: row i's edges at edge_off[i] - edge_off[r0] onward, in
// increasing (slot, j) order. An item finds its edges' places from the
// other items of its row: the edges of the planes before its own, per slot
// of its own plane the edges of all the row's words (the slots before) and
// of the words before it (its own slot). Every thread of the block calls
// this after the barrier that follows fill_items; ends with a block barrier.
__device__ __forceinline__ void expand_items(const EdgeList& ed, int n_items, int pack,
                                             int r0) {
  const int bits = 8 / pack;
  const uint32_t field_mask = ((1u << bits) - 1u) * 0x01010101u;
  const int item0 = ed.item_off[r0];
  const int edge0 = ed.edge_off[r0];
  for (int it = threadIdx.x; it < n_items; it += kThreads) {
    const uint32_t w = ed.item_w[it];
    const uint32_t meta = ed.item_meta[it];
    const int row = meta >> 13;
    const int plane = (meta >> 5) & 0xffu;
    int at = ed.edge_off[row] - edge0;
    uint32_t all = 0u, before = 0u;  // per slot of this plane, a byte each (<= 128)
    const int last = ed.item_off[row + 1] - item0;
    for (int k = ed.item_off[row] - item0; k < last; ++k) {
      const int pk = (ed.item_meta[k] >> 5) & 0xffu;
      if (pk > plane) break;
      const uint32_t wk = ed.item_w[k];
      if (pk < plane) {
        at += nonzero_fields(wk, bits);
      } else {
        const uint32_t c = slot_counts(wk, pack);
        all += c;
        if (k < it) before += c;
      }
    }
    const uint32_t col = 4u * (meta & 31u);
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      if (sl >= pack) continue;
      const uint32_t f = (w >> (bits * sl)) & field_mask;  // the slot's fields as bytes
      if (f != 0u) {
        int place = at + ((before >> (8 * sl)) & 0xffu);
        const uint32_t src = (uint32_t)ed.src_chunk[plane * pack + sl] * kChunk + col;
#pragma unroll
        for (int by = 0; by < 4; ++by) {
          const uint32_t m = (f >> (8 * by)) & 0xffu;
          if (m != 0u) ed.edge[place++] = (src + by) | m << 24;
        }
      }
      at += (all >> (8 * sl)) & 0xffu;
    }
  }
  __syncthreads();
}

// ---------------- the gather ----------------

// For the n edges at edge[0..n), copies seg_bytes bytes from base + row *
// row_bytes + off_bytes into buf + e * stride, in pieces of VEC bytes by
// cp.async (VEC 16, 8 or 4: base, row_bytes and off_bytes are multiples of
// it, and a last piece that runs over seg_bytes stays inside the row).
// Rows at or beyond n_rows read as zeros. A power of two of threads shares
// an edge, one piece each. The caller commits and waits.
template <int VEC>
__device__ __forceinline__ void gather_rows(unsigned char* buf, int stride,
                                            const unsigned char* base,
                                            size_t row_bytes, int off_bytes,
                                            int seg_bytes, const uint32_t* edge, int n,
                                            int n_rows) {
  const int pieces = (seg_bytes + VEC - 1) / VEC;
  const int shift = pieces > 1 ? min(32 - __clz(pieces - 1), 8) : 0;
  const int q0 = threadIdx.x & ((1 << shift) - 1);
  for (int e = threadIdx.x >> shift; e < n; e += kThreads >> shift) {
    const int row = edge[e] & kRowMask;
    unsigned char* dst = buf + (size_t)e * stride;
    const unsigned char* from = base + (size_t)row * row_bytes + off_bytes;
    for (int q = q0; q < pieces; q += 1 << shift) {
      if (row < n_rows) {
        cp_async<VEC>(dst + q * VEC, from + q * VEC);
      } else {
#pragma unroll
        for (int k = 0; k < VEC / 4; ++k)
          reinterpret_cast<uint32_t*>(dst + q * VEC)[k] = 0u;
      }
    }
  }
}

// Whether a 2-byte-aligned address lies 2 bytes after a 4-byte boundary.
__device__ __forceinline__ int odd_half(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 1) & 1u);
}

// The same for rows that are only 2-byte aligned (bf16 rows of odd length):
// the 4-byte words that cover the segment are copied by cp.async from the
// aligned address at or below its start, so that the segment lies 2 *
// odd_half(its start) bytes into the slot; a word that reaches outside
// [base, base + n_rows * row_bytes) is read by halves. The slot needs
// seg_bytes + 2 bytes.
__device__ __forceinline__ void gather_rows_shifted(unsigned char* buf, int stride,
                                                    const unsigned char* base,
                                                    size_t row_bytes, int off_bytes,
                                                    int seg_bytes, const uint32_t* edge,
                                                    int n, int n_rows) {
  const unsigned char* end = base + (size_t)n_rows * row_bytes;
  const int max_words = seg_bytes / 4 + 1;
  const int shift = max_words > 1 ? min(32 - __clz(max_words - 1), 8) : 0;
  const int q0 = threadIdx.x & ((1 << shift) - 1);
  for (int e = threadIdx.x >> shift; e < n; e += kThreads >> shift) {
    const int row = edge[e] & kRowMask;
    unsigned char* dst = buf + (size_t)e * stride;
    const unsigned char* start = base + (size_t)row * row_bytes + off_bytes;
    const int odd = odd_half(start);
    const unsigned char* from = start - 2 * odd;
    const int words = (seg_bytes + 2 * odd + 3) / 4;
    for (int q = q0; q < words; q += 1 << shift) {
      const unsigned char* p = from + 4 * q;
      if (row >= n_rows) {
        *reinterpret_cast<uint32_t*>(dst + 4 * q) = 0u;
      } else if (p >= base && p + 4 <= end) {
        cp_async<4>(dst + 4 * q, p);
      } else {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (p + 2 * k >= base && p + 2 * k + 2 <= end)
            reinterpret_cast<uint16_t*>(dst + 4 * q)[k] =
                __ldg(reinterpret_cast<const uint16_t*>(p) + k);
      }
    }
  }
}

// vec: 16, 8 or 4 (aligned rows) or 2 (gather_rows_shifted).
__device__ __forceinline__ void gather(int vec, unsigned char* buf, int stride,
                                       const void* base, size_t row_bytes,
                                       int off_bytes, int seg_bytes,
                                       const uint32_t* edge, int n, int n_rows) {
  const unsigned char* b = static_cast<const unsigned char*>(base);
  if (vec == 16) gather_rows<16>(buf, stride, b, row_bytes, off_bytes, seg_bytes, edge, n, n_rows);
  else if (vec == 8) gather_rows<8>(buf, stride, b, row_bytes, off_bytes, seg_bytes, edge, n, n_rows);
  else if (vec == 4) gather_rows<4>(buf, stride, b, row_bytes, off_bytes, seg_bytes, edge, n, n_rows);
  else gather_rows_shifted(buf, stride, b, row_bytes, off_bytes, seg_bytes, edge, n, n_rows);
}

// The widest copy that base, row_bytes and off_step (the offsets used are
// its multiples) all allow: 16, 8, 4 or 2 bytes.
inline int copy_width(const void* base, size_t row_bytes, size_t off_step) {
  for (int v = 16; v > 2; v >>= 1)
    if (reinterpret_cast<uintptr_t>(base) % v == 0 && row_bytes % v == 0 &&
        off_step % v == 0)
      return v;
  return 2;
}

// ---------------- the row walk ----------------

// A thread group's pass over one batch, list places [e0, e1) of the group
// of rows that ends at r1 (`last`: the group's last batch). The group owns
// rows row, row + row_step, ...; `row` and `open` (the row was begun in an
// earlier batch and its edges go on) are its state across the batches.
// list0 = edge_off[r0]. Op has begin(row), edges(lo, hi) for list places
// [lo, hi), all inside the batch, and end(row).
template <typename Op>
__device__ __forceinline__ void walk_rows(Op& op, int& row, bool& open, int row_step,
                                          int r1, const int* edge_off, int list0,
                                          int e0, int e1, bool last) {
  while (row < r1) {
    const int rs = edge_off[row] - list0;
    const int re = edge_off[row + 1] - list0;
    if (rs >= e1 && !last) break;  // begins in a later batch
    if (!open) op.begin(row);
    op.edges(rs > e0 ? rs : e0, re < e1 ? re : e1);
    if (re > e1 && !last) {  // goes on in the next batch
      open = true;
      break;
    }
    op.end(row);
    open = false;
    row += row_step;
  }
}

__host__ __device__ inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// Smallest power of two >= v, at most 32.
inline int group_size(int v) {
  int g = 1;
  while (g < v && g < 32) g <<= 1;
  return g;
}

}  // namespace bsda
