// Segment sum / min / max over dst-sorted edges — kernel 1 of the GAB loop.
//
// Replaces the TPU kernel repro/kernels/gab_gather.py:segment_reduce_pallas
// (pallas_call at gab_gather.py:127, body _kernel).  That kernel turns the
// reduction into a one-hot [Q, BE] x [BE, BR] MXU contraction (sum) or a
// masked select (min/max), which costs Q·E·R work per tile and only pays
// on a matrix unit.  Here the edges are CSR-sorted by dst (every tile is,
// tiles.py:build_tile), so each row owns a contiguous edge range.
//
//   out[r, q] = (+|min|max) contrib[e, q] over e with dst[e] == r
//
// The order of a row's float sum is fixed, and is the order of
// gab_fused.cu (seg_common.cuh): lane l of a warp combines edges lo + l,
// lo + l + 32, ... in turn, starting from the identity, then a butterfly
// at offsets 16, 8, 4, 2, 1 whose lane 0 is the result.  Lane 0's value
// is a tree: at offset m, position p < m takes combine(v[p], v[p + m]).
// For a row of n <= 32 edges, positions >= n hold the identity, and
// combine(x, identity) is x for every x this order produces (a sum never
// reaches -0.0 from a +0.0 start; NaN is already canonical), so the
// offsets >= n change nothing.  A short row therefore gives the same bits
// when its n edges sit on any n consecutive lanes and only the offsets
// below n run — which is what lets many short rows share a warp.
//
// Two launches, no atomics on the output, no scratch; the second runs on
// a side stream beside the first (see launch_both):
//
// 1. Rows.  A block owns kRowsPerBlock consecutive rows.  Two warps find
//    its edge slice with 32-way searches (a few dependent loads each);
//    the block copies the slice's contributions into shared memory
//    (cp.async, up to kCacheBytes) while it reads the slice's dst once,
//    coalesced, marking where dst changes (a slice too long for that —
//    one holding a hub row — takes one binary search a row instead).
//    Warp w then owns rows [32w, 32w + 32) of the block, lane l row
//    32w + l:
//    - empty rows: the owner lane writes the identity;
//    - rows of 1..32 edges: packed, in row order, into windows of 32
//      consecutive edges, one edge a lane, all Q columns of an edge by
//      one lane; the tree above runs over positions within each row;
//    - longer rows: on a list the warps share; the whole warp, lanes
//      strided over the row, loads issued in batches before their
//      in-order combines, then the 32-lane butterfly;
//    - hub rows (below) are left to launch 2.
// 2. Hubs.  A row is a hub when it holds two consecutive multiples m,
//    m + kHubEdges of the edge index, m being the first multiple at or
//    after its start.  So dst[m] == dst[m + kHubEdges] != dst[m -
//    kHubEdges] finds each hub exactly once without scratch: the blocks
//    of launch 2 test the multiples (consecutive multiples on different
//    blocks), and the block that finds a hub streams it through a ring
//    of kHubStages shared-memory chunks (cp.async, all threads), while
//    warp w combines column w of each chunk in the same lane order as
//    above.  A column's 32 in-order chains bound a hub; the ring keeps
//    them fed.
// Query columns go in chunks of up to 8 per pass; each column keeps the
// order it has alone, so a column equals its Q = 1 run.
//
// Bound on an H100: bytes.  The kernel must read contrib (4·Q bytes per
// edge) and dst (4 bytes per edge) and write out (4·Q bytes per row); the
// design reads each about once (Q <= 8), coalesced.
//
// Integer contributions (int32, int64) reduce in int64 — exact sums — and
// are cast back to their own type.  Ids outside [0, R) are dropped: they
// sort before row 0 or after row R - 1, outside every block's slice.
#include <mutex>

#include "seg_common.cuh"

using namespace seg;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCacheBytes = 40960;        // a row block's contributions
constexpr long long kScanEdges = 32768;   // longer slices: search per row
constexpr long long kHubEdges = 4096;
constexpr int kHubStages = 6;
constexpr int kHubChunkBytes = 16384;
constexpr int kMinBlocks = 4;             // row launch: <= 64 registers
constexpr int kHubBlocks = 512;

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<int> { using type = int4; };
template <> struct Vec<long long> { using type = longlong2; };

__device__ __forceinline__ void unpack(float4 w, float* o) {
  o[0] = w.x; o[1] = w.y; o[2] = w.z; o[3] = w.w;
}
__device__ __forceinline__ void unpack(int4 w, int* o) {
  o[0] = w.x; o[1] = w.y; o[2] = w.z; o[3] = w.w;
}
__device__ __forceinline__ void unpack(longlong2 w, long long* o) {
  o[0] = w.x; o[1] = w.y;
}

// QC values from p (columns at or past `valid` read as 0 and are never
// stored); 16-byte loads when ``vec`` (the caller checked alignment).
template <typename T, int QC>
__device__ __forceinline__ void load_cols(const T* p, int valid, bool vec,
                                          T* out) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  if (QC % kPer == 0 && vec) {
    using V = typename Vec<T>::type;
#pragma unroll
    for (int w = 0; w < QC / kPer; ++w)
      unpack(reinterpret_cast<const V*>(p)[w], out + w * kPer);
  } else {
#pragma unroll
    for (int q = 0; q < QC; ++q) out[q] = q < valid ? p[q] : T(0);
  }
}

template <typename T, typename Acc, int QC>
__device__ __forceinline__ void store_cols(T* __restrict__ out, long long r,
                                           int q_cols, int q0,
                                           const Acc* v) {
#pragma unroll
  for (int q = 0; q < QC; ++q)
    if (q0 + q < q_cols) out[r * q_cols + q0 + q] = static_cast<T>(v[q]);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Element-size padding of src within its 16-byte line.
template <typename T>
__device__ __forceinline__ int line_pad(const T* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) % 16 / sizeof(T));
}

// Asynchronous copy of src[0, count) into smem (16-byte aligned, room for
// count + 16 / sizeof(T) elements): element i lands at smem[line_pad(src) +
// i], so the body moves in 16-byte copies and only the ends element-wise.
// Every thread of the block calls it; the caller commits and waits.
template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* src, int count) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const int pad = line_pad(src);
  const int head = min((kPer - pad) % kPer, count);
  const int groups = (count - head) / kPer;
  T* to = smem + pad;
  for (int i = threadIdx.x; i < head; i += kThreads)
    cp_async<sizeof(T)>(to + i, src + i);
  for (int g = threadIdx.x; g < groups; g += kThreads)
    cp_async16(to + head + g * kPer, src + head + g * kPer);
  for (int i = head + groups * kPer + threadIdx.x; i < count; i += kThreads)
    cp_async<sizeof(T)>(to + i, src + i);
}

// First i in [lo, hi) with dst[i] >= key, else hi; dst ascending.  Called
// by a whole warp: 32 probes a step, so a few dependent loads in all.
__device__ long long warp_lower_bound(const int* __restrict__ dst,
                                      long long lo, long long hi,
                                      long long key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const long long p = lo + span * (lane + 1) / 33;
    const unsigned ge = __ballot_sync(kFull, dst[p] >= key);
    if (ge == 0) {
      lo = __shfl_sync(kFull, p, 31) + 1;
    } else {
      const int f = __ffs(ge) - 1;
      const long long below = __shfl_sync(kFull, p, f > 0 ? f - 1 : 0);
      hi = __shfl_sync(kFull, p, f);
      if (f > 0) lo = below + 1;
    }
  }
  const long long i = lo + lane;
  const unsigned ge = __ballot_sync(kFull, i < hi && dst[i] >= key);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

// Hub rows: those holding m = the first multiple of kHubEdges at or after
// their start, and m + kHubEdges.  Both launches use this test.
__device__ __forceinline__ bool is_hub(long long lo, long long hi,
                                       bool hubs) {
  const long long m = (lo + kHubEdges - 1) / kHubEdges * kHubEdges;
  return hubs && m + kHubEdges < hi;
}

// The block's edge slice [slice[0], slice[1]): rows r0 .. r0 + nrows.
__device__ void block_slice(const int* __restrict__ dst,
                            long long num_edges, long long r0, int nrows,
                            long long* slice) {
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    const long long lo = warp_lower_bound(dst, 0, num_edges, r0);
    if ((threadIdx.x & 31) == 0) slice[0] = lo;
  } else if (warp == 1) {
    const long long hi = warp_lower_bound(dst, 0, num_edges, r0 + nrows);
    if ((threadIdx.x & 31) == 0) slice[1] = hi;
  }
  __syncthreads();
}

// Edge ranges of the block's rows: bounds[t] = first edge of row r0 + t,
// t in [0, nrows].  dst values are clamped, so a dst that is not ascending
// never writes out of bounds.
__device__ void fill_bounds(const int* __restrict__ dst, long long r0,
                            int nrows, long long lo, long long hi,
                            long long* bounds) {
  if (hi - lo > kScanEdges) {
    // a hub slice: one binary search a row inside it
    for (int t = threadIdx.x; t <= nrows; t += kThreads)
      bounds[t] = lo + lower_bound(dst + lo, hi - lo, r0 + t);
    return;
  }
  const long long last_row = static_cast<long long>(nrows - 1);
  constexpr int kBatch = 8;                   // loads in flight a thread
  for (long long base = lo; base < hi; base += kBatch * kThreads) {
    int dv[kBatch], pv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      dv[u] = i < hi ? dst[i] : 0;
      pv[u] = i > lo && i < hi ? dst[i - 1] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      if (i >= hi) continue;
      const long long d = min(dv[u] - r0, last_row);
      const long long prev = i == lo ? -1 : max(pv[u] - r0, -1LL);
      for (long long t = prev + 1; t <= d; ++t) bounds[t] = i;
    }
  }
  const long long last =
      hi > lo ? min(max(dst[hi - 1] - r0, -1LL), last_row) : -1;
  for (long long t = last + 1 + threadIdx.x; t <= nrows; t += kThreads)
    bounds[t] = hi;
}

}  // namespace

template <typename T, typename Acc, int C, int QC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_reduce_kernel(const T* __restrict__ contrib,
                      const int* __restrict__ dst, T* __restrict__ out,
                      long long num_edges, long long num_rows, int q_cols,
                      bool hubs) {
  __shared__ long long bounds[kRowsPerBlock + 1];
  __shared__ long long slice[2];
  __shared__ int row_at[kWarps][32];  // window position -> owner lane
  __shared__ int long_rows[kRowsPerBlock], num_long, next_long;
  __shared__ __align__(16) unsigned char cache_bytes[kCacheBytes];
  T* cache = reinterpret_cast<T*>(cache_bytes);
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const int nrows = static_cast<int>(
      min(static_cast<long long>(kRowsPerBlock), num_rows - r0));
  block_slice(dst, num_edges, r0, nrows, slice);
  const long long blo = slice[0], bhi = slice[1];

  // Contributions of the slice's first cached_edges edges -> shared memory,
  // edge e at cache + pad + (e - blo) * q_cols.
  const long long edge_bytes = static_cast<long long>(q_cols) * sizeof(T);
  const long long cached_edges =
      max(0LL, min(bhi - blo, (kCacheBytes - 16) / edge_bytes));
  const T* slice_src = contrib + max(blo, 0LL) * q_cols;
  const int pad = line_pad(slice_src);
  copy_async(cache, slice_src, static_cast<int>(cached_edges * q_cols));
  cp_async_commit();
  if (threadIdx.x == 0) num_long = 0;
  fill_bounds(dst, r0, nrows, blo, bhi, bounds);
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int row0 = warp * 32;                 // first row of this warp
  const int mine = row0 + lane;               // the row this lane owns
  const bool owns = mine < nrows;
  // A row's range, clamped into the block's slice.
  const long long lo = owns ? min(max(bounds[mine], blo), bhi) : bhi;
  const long long hi = owns ? min(max(bounds[mine + 1], lo), bhi) : bhi;
  const long long n = hi - lo;
  // Rows of more than 32 edges, hubs aside, go on a list that the warps
  // share (which warp takes a row changes no bit of its result).
  if (owns && n > 32 && !is_hub(lo, hi, hubs))
    long_rows[atomicAdd(&num_long, 1)] = mine;
  if (threadIdx.x == 0) next_long = 0;
  __syncthreads();                            // the last block barrier
  const int wrows = max(min(32, nrows - row0), 0);
  const long long wlo = min(max(bounds[min(row0, nrows)], blo), bhi);
  const long long whi = min(max(bounds[min(row0 + wrows, nrows)], wlo), bhi);
  const Acc ident = Identity<T, C>::value();
  const bool global_aligned = reinterpret_cast<uintptr_t>(contrib) % 16 == 0;

  // columns q0 .. q0 + QC of edge e, from shared memory where cached
  auto load = [&](long long e, int q0, T* v) {
    const bool vec = edge_bytes % 16 == 0 && (q0 * sizeof(T)) % 16 == 0 &&
                     q0 + QC <= q_cols;
    if (e - blo < cached_edges)
      load_cols<T, QC>(cache + pad + (e - blo) * q_cols + q0, q_cols - q0,
                       vec && pad == 0, v);
    else
      load_cols<T, QC>(contrib + e * q_cols + q0, q_cols - q0,
                       vec && global_aligned, v);
  };
  Acc v[QC];
  T c[QC];

  for (int q0 = 0; q0 < q_cols; q0 += QC) {
    if (owns && n == 0) {
#pragma unroll
      for (int q = 0; q < QC; ++q) v[q] = ident;
      store_cols<T, Acc, QC>(out, r0 + mine, q_cols, q0, v);
    }

    // Rows of 1..32 edges, packed into windows of 32 edges.
    long long ew = wlo;
    while (ew < whi) {
      const bool in_win = owns && n >= 1 && n <= 32 && lo >= ew &&
                          hi <= ew + 32;
      if (in_win) row_at[warp][lo - ew] = lane;
      const unsigned heads =
          __reduce_or_sync(kFull, in_win ? 1u << (lo - ew) : 0u);
      const unsigned tails =
          __reduce_or_sync(kFull, in_win ? 1u << (hi - 1 - ew) : 0u);
      if (heads == 0) {
        // the row starting at ew has more than 32 edges: skip it here
        const unsigned at = __ballot_sync(kFull, owns && lo == ew && n > 32);
        if (at == 0) break;                    // only if dst is not ascending
        ew = __shfl_sync(kFull, hi, __ffs(at) - 1);
        continue;
      }
      __syncwarp();
      const int last = 31 - __clz(tails);
      const bool active = lane <= last;
      const unsigned le = heads & (lanemask_lt | (1u << lane));
      const int h = 31 - __clz(le);
      const int t = __ffs(tails & ~lanemask_lt) - 1;
      const int p = lane - h;
      const int len = t - h + 1;
      if (active) load(ew + lane, q0, c);
#pragma unroll
      for (int q = 0; q < QC; ++q)
        v[q] = active ? combine<C>(ident, static_cast<Acc>(c[q])) : ident;
      const int longest = __reduce_max_sync(kFull, active ? len : 0);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        if (m >= longest) continue;            // uniform: no lane takes it
        const bool take = active && p < m && p + m < len;
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          const Acc u = __shfl_down_sync(kFull, v[q], m);
          if (take) v[q] = combine<C>(v[q], u);
        }
      }
      if (active && p == 0)
        store_cols<T, Acc, QC>(out, r0 + row0 + row_at[warp][lane], q_cols,
                               q0, v);
      __syncwarp();                            // row_at is rewritten next
      ew += last + 1;
    }
  }

  // Long rows from the block's list: the whole warp, one at a time, in
  // batches of kUnroll loads a lane issued before their in-order combines.
  constexpr int kUnroll = 8 / QC > 0 ? 8 / QC : 1;
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(&next_long, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= num_long) break;
    const int row = long_rows[k];
    const long long rlo = min(max(bounds[row], blo), bhi);
    const long long rhi = min(max(bounds[row + 1], rlo), bhi);
    for (int q0 = 0; q0 < q_cols; q0 += QC) {
#pragma unroll
      for (int q = 0; q < QC; ++q) v[q] = ident;
      for (long long e = rlo + lane; e < rhi; e += kUnroll * 32) {
        T buf[kUnroll][QC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (e + u * 32 < rhi) load(e + u * 32, q0, buf[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (e + u * 32 < rhi)
#pragma unroll
            for (int q = 0; q < QC; ++q)
              v[q] = combine<C>(v[q], static_cast<Acc>(buf[u][q]));
      }
#pragma unroll
      for (int q = 0; q < QC; ++q) v[q] = warp_reduce<C>(v[q]);
      if (lane == 0) store_cols<T, Acc, QC>(out, r0 + row, q_cols, q0, v);
    }
  }
}

// Launch 2: hub rows, one block each, streamed through a shared ring.
template <typename T, typename Acc, int C, int QC>
__global__ void __launch_bounds__(kThreads)
segment_hub_kernel(const T* __restrict__ contrib,
                   const int* __restrict__ dst, T* __restrict__ out,
                   long long num_edges, long long num_rows, int q_cols) {
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  T* ring = reinterpret_cast<T*>(ring_bytes);
  __shared__ long long found[kThreads];
  __shared__ long long range[2];
  __shared__ int num_found;
  constexpr int kChunk = kHubChunkBytes / static_cast<int>(sizeof(T));
  constexpr int kSlot = kChunk + 16 / static_cast<int>(sizeof(T));
  constexpr int kUnroll = 16;
  const long long chunk_edges = (kChunk / q_cols) & ~31LL;   // >= 32
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Acc ident = Identity<T, C>::value();
  const long long multiples = (num_edges - 1) / kHubEdges;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;

  for (long long j0 = blockIdx.x; j0 < multiples; j0 += stride) {
    if (threadIdx.x == 0) num_found = 0;
    __syncthreads();
    const long long j = j0 + static_cast<long long>(gridDim.x) * threadIdx.x;
    if (j < multiples) {
      const long long m = j * kHubEdges;
      const int r = dst[m];
      if (r >= 0 && r < num_rows && dst[m + kHubEdges] == r &&
          (m == 0 || dst[m - kHubEdges] != r))
        found[atomicAdd(&num_found, 1)] = m;  // order of hubs is free
    }
    __syncthreads();
    for (int f = 0; f < num_found; ++f) {
      const long long m = found[f];
      const int r = dst[m];
      if (warp == 0) {
        const long long lo =
            warp_lower_bound(dst, max(m - kHubEdges + 1, 0LL), m + 1, r);
        if (lane == 0) range[0] = lo;
      } else if (warp == 1) {
        const long long hi =
            warp_lower_bound(dst, m + kHubEdges + 1, num_edges, r + 1LL);
        if (lane == 0) range[1] = hi;
      }
      __syncthreads();
      const long long lo = range[0], hi = range[1];
      const long long chunks = (hi - lo + chunk_edges - 1) / chunk_edges;
      // warp w combines column q0 + w of every edge, lanes in the order
      // above; the other warps only copy
      for (int q0 = 0; q0 < q_cols; q0 += QC) {
        const int col = q0 + warp;
        const bool consumer = warp < QC && col < q_cols;
        Acc v = ident;
        // chunk k: edges [lo + k·chunk_edges, ...) into ring slot k % S
        auto issue = [&](long long k) {
          if (k < chunks) {
            const long long c0 = lo + k * chunk_edges;
            const long long c1 = min(c0 + chunk_edges, hi);
            copy_async(ring + (k % kHubStages) * kSlot, contrib + c0 * q_cols,
                       static_cast<int>((c1 - c0) * q_cols));
          }
          cp_async_commit();                   // empty groups keep count
        };
        for (int k = 0; k < kHubStages - 1; ++k) issue(k);
        for (long long k = 0; k < chunks; ++k) {
          issue(k + kHubStages - 1);
          cp_async_wait<kHubStages - 1>();
          __syncthreads();
          if (consumer) {
            // lane l takes edges c0 + l, c0 + l + 32, ...: c0 - lo is a
            // multiple of 32, so each lane keeps its order over the row
            const T* chunk_src = contrib + (lo + k * chunk_edges) * q_cols;
            const T* slot =
                ring + (k % kHubStages) * kSlot + line_pad(chunk_src) + col;
            const int count = static_cast<int>(
                min(chunk_edges, hi - lo - k * chunk_edges));
            int i = lane;
            for (; i + (kUnroll - 1) * 32 < count; i += kUnroll * 32) {
              T x[kUnroll];
#pragma unroll
              for (int u = 0; u < kUnroll; ++u)
                x[u] = slot[(i + u * 32) * q_cols];
#pragma unroll
              for (int u = 0; u < kUnroll; ++u)
                v = combine<C>(v, static_cast<Acc>(x[u]));
            }
            for (; i < count; i += 32)
              v = combine<C>(v, static_cast<Acc>(slot[i * q_cols]));
          }
          __syncthreads();                     // the slot is refilled next
        }
        cp_async_wait<0>();
        if (consumer) {
          v = warp_reduce<C>(v);
          if (lane == 0) out[static_cast<long long>(r) * q_cols + col] =
              static_cast<T>(v);
        }
        __syncthreads();
      }
    }
    __syncthreads();                           // num_found is reset next
  }
}

// The hub launch runs beside the row launch on a side stream of the
// device, forked from and joined back into the caller's stream with events,
// so a call costs about the longer of the two.  Made once per device; the
// lock also keeps two host threads' forks and joins apart.
namespace {

struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};
std::mutex side_mutex;
SideStream side_streams[64];

cudaError_t side_stream(SideStream** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  SideStream& side = side_streams[dev];
  if (side.stream == nullptr) {
    SideStream made;
    if ((err = cudaStreamCreateWithFlags(&made.stream,
                                         cudaStreamNonBlocking)) != 0 ||
        (err = cudaEventCreateWithFlags(&made.fork,
                                        cudaEventDisableTiming)) != 0 ||
        (err = cudaEventCreateWithFlags(&made.join,
                                        cudaEventDisableTiming)) != 0)
      return err;
    side = made;
  }
  *out = &side;
  return cudaSuccess;
}

}  // namespace

template <typename T, typename Acc, int C, int QC>
static cudaError_t launch_both(dim3 grid, cudaStream_t stream,
                               const T* contrib, const int* dst, T* out,
                               long long num_edges, long long num_rows,
                               int q_cols) {
  // hubs need a chunk of at least 32 edges
  const bool hubs =
      static_cast<long long>(q_cols) * 32 * sizeof(T) <= kHubChunkBytes &&
      num_edges > kHubEdges;
  if (!hubs) {
    segment_reduce_kernel<T, Acc, C, QC><<<grid, kThreads, 0, stream>>>(
        contrib, dst, out, num_edges, num_rows, q_cols, false);
    return cudaGetLastError();
  }
  std::lock_guard<std::mutex> lock(side_mutex);
  SideStream* side = nullptr;
  cudaError_t err = side_stream(&side);
  if (err != cudaSuccess) return err;
  const long long multiples = (num_edges - 1) / kHubEdges;
  const int blocks = static_cast<int>(min(multiples, 1LL * kHubBlocks));
  const int ring = kHubStages * (kHubChunkBytes + 16);
  if ((err = cudaFuncSetAttribute(segment_hub_kernel<T, Acc, C, QC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  ring)) != 0 ||
      (err = cudaEventRecord(side->fork, stream)) != 0 ||
      (err = cudaStreamWaitEvent(side->stream, side->fork, 0)) != 0)
    return err;
  segment_hub_kernel<T, Acc, C, QC><<<blocks, kThreads, ring, side->stream>>>(
      contrib, dst, out, num_edges, num_rows, q_cols);
  if ((err = cudaGetLastError()) != 0) return err;
  segment_reduce_kernel<T, Acc, C, QC><<<grid, kThreads, 0, stream>>>(
      contrib, dst, out, num_edges, num_rows, q_cols, true);
  if ((err = cudaGetLastError()) != 0 ||
      (err = cudaEventRecord(side->join, side->stream)) != 0 ||
      (err = cudaStreamWaitEvent(stream, side->join, 0)) != 0)
    return err;
  return cudaSuccess;
}

template <typename T, typename Acc, int C>
static cudaError_t launch_cols(dim3 grid, cudaStream_t stream,
                               const T* contrib, const int* dst, T* out,
                               long long num_edges, long long num_rows,
                               int q_cols) {
  if (q_cols == 1)
    return launch_both<T, Acc, C, 1>(grid, stream, contrib, dst, out,
                                     num_edges, num_rows, q_cols);
  if (q_cols == 2)
    return launch_both<T, Acc, C, 2>(grid, stream, contrib, dst, out,
                                     num_edges, num_rows, q_cols);
  if (q_cols <= 4)
    return launch_both<T, Acc, C, 4>(grid, stream, contrib, dst, out,
                                     num_edges, num_rows, q_cols);
  return launch_both<T, Acc, C, 8>(grid, stream, contrib, dst, out,
                                   num_edges, num_rows, q_cols);
}

template <typename T, typename Acc>
static int launch(const T* contrib, const int* dst, T* out,
                  long long num_edges, long long num_rows, int q_cols,
                  int combine_code, cudaStream_t stream) {
  const dim3 grid(num_row_blocks(num_rows));
  switch (combine_code) {
    case kSum:
      return static_cast<int>(launch_cols<T, Acc, kSum>(
          grid, stream, contrib, dst, out, num_edges, num_rows, q_cols));
    case kMin:
      return static_cast<int>(launch_cols<T, Acc, kMin>(
          grid, stream, contrib, dst, out, num_edges, num_rows, q_cols));
    case kMax:
      return static_cast<int>(launch_cols<T, Acc, kMax>(
          grid, stream, contrib, dst, out, num_edges, num_rows, q_cols));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" {

// contrib [E, Q] and out [R, Q] row-major, dst [E] ascending int32.
// Returns the cudaError_t of the launches (0 = success).
int segment_reduce_f32(const float* contrib, const int* dst, float* out,
                       long long num_edges, long long num_rows, int q_cols,
                       int combine_code, void* stream) {
  return launch<float, float>(contrib, dst, out, num_edges, num_rows, q_cols,
                              combine_code,
                              static_cast<cudaStream_t>(stream));
}

int segment_reduce_i32(const int* contrib, const int* dst, int* out,
                       long long num_edges, long long num_rows, int q_cols,
                       int combine_code, void* stream) {
  return launch<int, long long>(contrib, dst, out, num_edges, num_rows,
                                q_cols, combine_code,
                                static_cast<cudaStream_t>(stream));
}

int segment_reduce_i64(const long long* contrib, const int* dst,
                       long long* out, long long num_edges,
                       long long num_rows, int q_cols, int combine_code,
                       void* stream) {
  return launch<long long, long long>(contrib, dst, out, num_edges, num_rows,
                                      q_cols, combine_code,
                                      static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
