// The row layout of the two GAB segment kernels (segment_reduce.cu,
// gab_fused.cu): one row launch and one hub launch, templated on where an
// edge's values come from (a Source) and what happens to a row's result
// (an Epilogue), so both kernels sum every row in one order by
// construction.
//
// The order of a row's float sum: lane l of a warp combines edges lo + l,
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
// Rows [0, num_rows) are reduced; rows [num_rows, row_cap) are the
// epilogue's alone (the fused kernel copies old into them).  Two launches,
// no atomics on values; the second runs on a side stream beside the first
// (see launch_both):
//
// 1. Rows.  A block owns kRows consecutive rows (block_r: 128, 256 or
//    512, a thread a row).  Two warps find its edge slice — up to the
//    first edge of row min(r0 + kRows, num_rows) — with 32-way searches
//    (a few dependent loads each); the block copies the slice's edge
//    values into dynamic shared memory (cp.async, up to kCacheBytesPerRow
//    bytes a row) while it
//    reads the slice's dst once, coalesced, marking where dst changes (a
//    slice too long for that — one holding a hub row — takes one binary
//    search a row instead).  Warp w then owns rows [32w, 32w + 32) of the
//    block, lane l row 32w + l:
//    - longer rows: on a list the warps share, taken first; the whole
//      warp, lanes strided over the row, loads issued in batches before
//      their in-order combines, then the 32-lane butterfly;
//    - empty rows: the owner lane puts the identity;
//    - rows of 1..32 edges: packed, in row order, into windows of 32
//      consecutive edges, one edge a lane, all Q columns of an edge by
//      one lane; the tree above runs over positions within each row, and
//      the row's first lane puts the result;
//    - hub rows (below) are left to launch 2.
//    A block wholly past num_rows only runs the epilogue's keep().
// 2. Hubs.  A row below num_rows is a hub when it holds two consecutive
//    multiples m, m + H of the edge index (H = 2^shift, hub_shift(): at
//    least block_e, a power of two, 256 by default),
//    m being the first multiple at or after its start.  So dst[m] ==
//    dst[m + H] != dst[m - H] finds each hub exactly once without a list:
//    the kHubBlocks groups of launch 2 test the multiples (a thread each),
//    and the kHubGroups blocks of the group that find a hub stream it
//    through rings of kHubStages shared-memory chunks (cp.async, all
//    threads), each block the edges of its kHubLanes lanes, while
//    consumer threads combine one lane and column each in the lane order
//    above (chunks span multiples of 32 edges); the butterfly then runs
//    over the 32 lanes' values (see hub_kernel).  H is as small as 256
//    edges by default: a row block streams all its rows through one SM,
//    so long rows left there hold the launch back, while a hub's bytes
//    spread over kHubGroups SMs.  But a group takes its hubs one after
//    another, each at a fixed cost (searches, the ring's fill, the
//    meeting at scratch), so H grows with the edge list until it holds at
//    most kHubMaxMultiples multiples, a few a group.  Rows are disjoint,
//    so nothing is merged across launches.
// The block sizes (block_e, block_r) change no bit of any row: a warp's
// 32 rows are the same aligned rows at every kRows (so are its windows of
// short rows), a long row is summed in the lane order above by whichever
// launch takes it, and both launches take the same shift, so the row
// launch leaves exactly the rows the hub launch finds.
// Query columns go in chunks of up to 8 per pass; each column keeps the
// order it has alone, so a column equals its Q = 1 run.
//
// The hub launch's lane partials and arrival counters are the caller's
// (hub_scratch_size() says how many; the counters start at 0 and the
// kernel leaves them at 0), allocated by the wrappers from PyTorch's
// allocator, one pair a library and device: the library's side stream
// runs its calls' hub launches in order.
//
// A Source has types Val (an edge value as loaded) and Acc (the
// accumulator), kSlackBytes (shared memory it needs beyond its edges'
// bytes), and edge_bytes(q), hub_chunk_edges(q), stage() (issue the
// cp.async copies of edges [e0, e0 + count) into shared memory),
// staged() (where stage() put them), load<QC>() (columns q0 .. q0 + QC of
// one edge, from shared memory where staged), and for the hub launch
// hub_chunk_edges(q), stage_hub() and staged_hub() (group g's edges of a
// chunk, as copy_runs() lays them out) and hub_value() (one column of one
// staged edge).  An Epilogue has
// put(r, q, q_cols, acc) for a reduced row and, with kKeepsOld,
// keep(k0, k1) for the entries of rows past num_rows.
#pragma once

#include <mutex>

#include "seg_common.cuh"

namespace seg {

constexpr unsigned kFull = 0xffffffffu;
// a row block's edge values: 40,960 bytes at 256 rows, so an SM holds
// about 180 KiB of them at every row-block size (1,024 threads)
constexpr int kCacheBytesPerRow = 160;
constexpr int kResidentThreads = 1024;    // row launch: <= 64 registers
constexpr int kHubThreads = 256;          // hub launch: threads a block
constexpr long long kScanEdges = 32768;   // longer slices: search per row
constexpr int kHubChunkBytes = 16384;     // a hub block's data a ring slot
// Hub rows hold two multiples of H = 2^s edges, H >= block_e (2^8 by
// default) and at most kHubMaxMultiples multiples in the edge list
// (hub_shift());
// kHubGroups blocks of kHubLanes lanes each stream one, through
// kHubStages ring slots a block (room beside it for row blocks); up to
// kHubBlocks groups test the multiples.
constexpr int kDefaultHubShift = 8;
constexpr long long kHubMaxMultiples = 16384;
constexpr int kHubGroups = 4;
constexpr int kHubLanes = 32 / kHubGroups;
constexpr int kHubStages = 3;
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

// A read of an input that no thread writes: through the read-only path
// from device memory, plainly from shared memory.
template <bool kGlobal, typename T>
__device__ __forceinline__ T read(const T* p) {
  if constexpr (kGlobal) return __ldg(p);
  else return *p;
}

// QC values from p (columns at or past `valid` read as 0 and are never
// stored); 16-byte loads when ``vec`` (the caller checked alignment).
template <typename T, int QC, bool kGlobal>
__device__ __forceinline__ void load_cols(const T* p, int valid, bool vec,
                                          T* out) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  if (QC % kPer == 0 && vec) {
    using V = typename Vec<T>::type;
#pragma unroll
    for (int w = 0; w < QC / kPer; ++w)
      unpack(read<kGlobal>(reinterpret_cast<const V*>(p) + w),
             out + w * kPer);
  } else {
#pragma unroll
    for (int q = 0; q < QC; ++q)
      out[q] = q < valid ? read<kGlobal>(p + q) : T(0);
  }
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
__host__ __device__ __forceinline__ int line_pad(const T* src) {
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
  const int nt = blockDim.x;
  for (int i = threadIdx.x; i < head; i += nt)
    cp_async<sizeof(T)>(to + i, src + i);
  for (int g = threadIdx.x; g < groups; g += nt)
    cp_async16(to + head + g * kPer, src + head + g * kPer);
  for (int i = head + groups * kPer + threadIdx.x; i < count; i += nt)
    cp_async<sizeof(T)>(to + i, src + i);
}

// Group g's edges of a hub chunk: run u is edges e0 + 32u + [0, kHubLanes)
// below `end` (e0 = the chunk's first edge + g·kHubLanes), w elements an
// edge, copied from src + (e0 + 32u)·w to smem + u·kHubLanes·w — staged
// edge i = u·kHubLanes + l at smem[i·w].  16-byte copies where the runs
// start on the 16-byte grid (all or none do: they are 32·w elements
// apart, a multiple of 16 bytes), else element-wise.  Every thread of the
// block calls it; the caller commits and waits.
template <typename T>
__device__ __forceinline__ void copy_runs(T* smem, const T* src, long long e0,
                                          int runs, int w, long long end) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const int per = kHubLanes * w;            // elements a run
  if (line_pad(src + e0 * w) == 0) {
    const int pieces = per / kPer;
    for (int t = threadIdx.x; t < runs * pieces; t += kHubThreads) {
      const int u = t / pieces, f = t % pieces * kPer;
      const long long first = e0 + 32LL * u;
      const T* from = src + first * w + f;
      T* to = smem + u * per + f;
      if (first + (f + kPer - 1) / w < end) {
        cp_async16(to, from);
      } else {
        for (int x = 0; x < kPer; ++x)
          if (first + (f + x) / w < end) cp_async<sizeof(T)>(to + x, from + x);
      }
    }
  } else {
    for (int t = threadIdx.x; t < runs * per; t += kHubThreads) {
      const int u = t / per, f = t % per;
      const long long first = e0 + 32LL * u;
      if (first + f / w < end)
        cp_async<sizeof(T)>(smem + t, src + first * w + f);
    }
  }
}

// First i in [lo, hi) with dst[i] >= key, else hi; dst ascending.  Called
// by a whole warp: 32 probes a step, so a few dependent loads in all.
__device__ inline long long warp_lower_bound(const int* __restrict__ dst,
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

// log2 of H for an edge list of num_edges, H at least 2^min_shift (see
// kHubMaxMultiples).
inline int hub_shift(long long num_edges, int min_shift) {
  int s = min_shift;
  while (((num_edges - 1) >> s) > kHubMaxMultiples) ++s;
  return s;
}

// Hub rows: those holding m = the first multiple of H = 2^shift at or
// after their start, and m + H; none when shift is 0.  Both launches use
// this test.
__device__ __forceinline__ bool is_hub(long long lo, long long hi,
                                       int shift) {
  const long long h = 1LL << shift;
  const long long m = ((lo + h - 1) >> shift) << shift;
  return shift > 0 && m + h < hi;
}

// The block's edge slice [slice[0], slice[1]): rows r0 .. r0 + nrows.
__device__ inline void block_slice(const int* __restrict__ dst,
                                   long long num_edges, long long r0,
                                   int nrows, long long* slice) {
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
// never writes out of bounds.  All kT threads of the block.
template <int kT>
__device__ inline void fill_bounds(const int* __restrict__ dst, long long r0,
                                   int nrows, long long lo, long long hi,
                                   long long* bounds) {
  if (hi - lo > kScanEdges) {
    // a hub slice: one binary search a row inside it
    for (int t = threadIdx.x; t <= nrows; t += kT)
      bounds[t] = lo + lower_bound(dst + lo, hi - lo, r0 + t);
    return;
  }
  const long long last_row = static_cast<long long>(nrows - 1);
  constexpr int kBatch = 8;                   // loads in flight a thread
  for (long long base = lo; base < hi; base += kBatch * kT) {
    int dv[kBatch], pv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = base + u * kT + threadIdx.x;
      dv[u] = i < hi ? dst[i] : 0;
      pv[u] = i > lo && i < hi ? dst[i - 1] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = base + u * kT + threadIdx.x;
      if (i >= hi) continue;
      const long long d = min(dv[u] - r0, last_row);
      const long long prev = i == lo ? -1 : max(pv[u] - r0, -1LL);
      for (long long t = prev + 1; t <= d; ++t) bounds[t] = i;
    }
  }
  const long long last =
      hi > lo ? min(max(dst[hi - 1] - r0, -1LL), last_row) : -1;
  for (long long t = last + 1 + threadIdx.x; t <= nrows; t += kT)
    bounds[t] = hi;
}

template <int QC, class Epi, typename Acc>
__device__ __forceinline__ void put_cols(const Epi& epi, long long r, int q0,
                                         int q_cols, const Acc* v) {
#pragma unroll
  for (int q = 0; q < QC; ++q)
    if (q0 + q < q_cols) epi.put(r, q0 + q, q_cols, v[q]);
}

// Launch 1: the rows of one block each, kRows threads and
// kCacheBytesPerRow · kRows bytes of dynamic shared memory a block.
template <class Src, class Epi, int C, int QC, int kRows>
__global__ void __launch_bounds__(kRows, kResidentThreads / kRows)
row_kernel(const Src source, const Epi epi, const int* __restrict__ dst,
           long long num_edges, long long num_rows, long long row_cap,
           int q_cols, int shift) {
  using Val = typename Src::Val;
  using Acc = typename Src::Acc;
  constexpr int kCacheBytes = kCacheBytesPerRow * kRows;
  __shared__ long long bounds[kRows + 1];
  __shared__ long long slice[2];
  __shared__ int row_at[kRows / 32][32];  // window position -> owner lane
  __shared__ int long_rows[kRows], num_long, next_long;
  extern __shared__ __align__(16) unsigned char cache[];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  if constexpr (Epi::kKeepsOld) {
    epi.keep(max(r0, num_rows) * q_cols,
             min(r0 + kRows, row_cap) * q_cols);
    if (r0 >= num_rows) return;                // the whole block is kept
  }
  const int nrows = static_cast<int>(
      min(static_cast<long long>(kRows), num_rows - r0));
  block_slice(dst, num_edges, r0, nrows, slice);
  const long long blo = slice[0], bhi = slice[1];

  // Values of the slice's first `cached` edges -> shared memory.
  const long long cached = max(0LL, min(bhi - blo, static_cast<long long>(
      (kCacheBytes - Src::kSlackBytes) / source.edge_bytes(q_cols))));
  const typename Src::Staged st =
      source.stage(cache, blo, static_cast<int>(cached), q_cols);
  cp_async_commit();
  if (threadIdx.x == 0) num_long = 0;
  fill_bounds<kRows>(dst, r0, nrows, blo, bhi, bounds);
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
  if (owns && n > 32 && !is_hub(lo, hi, shift))
    long_rows[atomicAdd(&num_long, 1)] = mine;
  if (threadIdx.x == 0) next_long = 0;
  __syncthreads();                            // the last block barrier
  const int wrows = max(min(32, nrows - row0), 0);
  const long long wlo = min(max(bounds[min(row0, nrows)], blo), bhi);
  const long long whi = min(max(bounds[min(row0 + wrows, nrows)], wlo), bhi);
  const Acc ident = Identity<Val, C>::value();

  // columns q0 .. q0 + QC of edge e, from shared memory where staged
  auto load = [&](long long e, int q0, Val* v) {
    source.template load<QC>(st, e, blo, cached, q0, q_cols, v);
  };
  Acc v[QC];
  Val c[QC];

  // Long rows from the block's list first: the whole warp, one at a time,
  // in batches of kUnroll loads a lane issued before their in-order
  // combines.  They come before the warp's own short rows, not after: with
  // the windows first, ptxas (CUDA 12.8, -O1 to -O3) miscompiled the int32
  // min/max instantiations, which faulted on a skewed list with negative
  // values (ROADMAP.md C.1).  A row's order is the same either way.
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
        Val buf[kUnroll][QC];
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
      if (lane == 0) put_cols<QC>(epi, r0 + row, q0, q_cols, v);
    }
  }

  for (int q0 = 0; q0 < q_cols; q0 += QC) {
    if (owns && n == 0) {
#pragma unroll
      for (int q = 0; q < QC; ++q) v[q] = ident;
      put_cols<QC>(epi, r0 + mine, q0, q_cols, v);
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
        put_cols<QC>(epi, r0 + row0 + row_at[warp][lane], q0, q_cols, v);
      __syncwarp();                            // row_at is rewritten next
      ew += last + 1;
    }
  }
}

// Launch 2: hub rows, streamed through a shared ring by kHubGroups blocks
// each: block g of a hub copies and combines only lanes [g·L, (g + 1)·L)
// of the 32 (L = kHubLanes), i.e. edges c0 + 32u + g·L + [0, L) of each
// chunk — 32-byte runs or longer, so no byte is fetched twice — so a
// hub's bytes spread over that many SMs.  Each block writes its lanes'
// partial values to scratch and the last of the hub's blocks to arrive
// (an integer counter a hub, reset by it) runs the butterfly over the 32:
// the same tree, whichever block is last.
template <class Src, class Epi, int C, int QC>
__global__ void __launch_bounds__(kHubThreads)
hub_kernel(const Src source, const Epi epi, const int* __restrict__ dst,
           long long num_edges, long long num_rows, int q_cols,
           int shift, typename Src::Acc* scratch, int* counters) {
  using Acc = typename Src::Acc;
  constexpr int kSlot = kHubChunkBytes + Src::kSlackBytes;
  constexpr int kUnroll = 16;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ long long found[kHubThreads];
  __shared__ long long range[2];
  __shared__ int num_found, is_last;
  const long long chunk_edges = source.hub_chunk_edges(q_cols);  // 32·k
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = static_cast<int>(blockIdx.x % kHubGroups);
  const long long jb = blockIdx.x / kHubGroups;
  const long long groups = gridDim.x / kHubGroups;
  const Acc ident = Identity<typename Src::Val, C>::value();
  const long long hub_edges = 1LL << shift;
  const long long multiples = (num_edges - 1) >> shift;
  const int passes = (q_cols + QC - 1) / QC;
  // consumer thread: lane li of the group, column cq of the pass
  const int li = threadIdx.x % kHubLanes;
  const int cq = threadIdx.x / kHubLanes;

  for (long long j0 = jb; j0 < multiples; j0 += groups * kHubThreads) {
    if (threadIdx.x == 0) num_found = 0;
    __syncthreads();
    const long long j = j0 + groups * threadIdx.x;
    if (j < multiples) {
      const long long m = j << shift;
      const int r = dst[m];
      if (r >= 0 && r < num_rows && dst[m + hub_edges] == r &&
          (m == 0 || dst[m - hub_edges] != r))
        found[atomicAdd(&num_found, 1)] = m;  // order of hubs is free
    }
    __syncthreads();
    for (int f = 0; f < num_found; ++f) {
      const long long m = found[f];
      const int r = dst[m];
      if (warp == 0) {
        const long long lo =
            warp_lower_bound(dst, max(m - hub_edges + 1, 0LL), m + 1, r);
        if (lane == 0) range[0] = lo;
      } else if (warp == 1) {
        const long long hi =
            warp_lower_bound(dst, m + hub_edges + 1, num_edges, r + 1LL);
        if (lane == 0) range[1] = hi;
      }
      __syncthreads();
      const long long lo = range[0], hi = range[1];
      const long long chunks = (hi - lo + chunk_edges - 1) / chunk_edges;
      auto slot = [&](long long k) { return ring + (k % kHubStages) * kSlot; };
      auto count = [&](long long k) {
        return static_cast<int>(min(chunk_edges, hi - lo - k * chunk_edges));
      };
      for (int q0 = 0; q0 < q_cols; q0 += QC) {
        const int col = q0 + cq;
        const bool consumer = cq < QC && col < q_cols;
        Acc v = ident;
        // chunk k: edges [lo + k·chunk_edges, ...) into ring slot k % S
        auto issue = [&](long long k) {
          if (k < chunks)
            source.stage_hub(slot(k), lo + k * chunk_edges, count(k), g,
                             q_cols);
          cp_async_commit();                   // empty groups keep count
        };
        for (int k = 0; k < kHubStages - 1; ++k) issue(k);
        for (long long k = 0; k < chunks; ++k) {
          issue(k + kHubStages - 1);
          cp_async_wait<kHubStages - 1>();
          __syncthreads();
          if (consumer) {
            // lane g·L + li takes edges c0 + g·L + li, then + 32, ...:
            // c0 - lo is a multiple of 32, so it keeps its order over the
            // row; i indexes the group's staged edges, o the chunk's
            const typename Src::Staged st = source.staged_hub(
                slot(k), lo + k * chunk_edges, count(k), g, q_cols);
            const int n = count(k);
            int i = li, o = g * kHubLanes + li;
            for (; o + (kUnroll - 1) * 32 < n;
                 i += kUnroll * kHubLanes, o += kUnroll * 32) {
              Acc x[kUnroll];
#pragma unroll
              for (int u = 0; u < kUnroll; ++u)
                x[u] = source.hub_value(st, i + u * kHubLanes, col, q_cols);
#pragma unroll
              for (int u = 0; u < kUnroll; ++u) v = combine<C>(v, x[u]);
            }
            for (; o < n; i += kHubLanes, o += 32)
              v = combine<C>(v, source.hub_value(st, i, col, q_cols));
          }
          __syncthreads();                     // the slot is refilled next
        }
        cp_async_wait<0>();
        const long long id = (m >> shift) * passes + q0 / QC;
        if (consumer) scratch[(id * QC + cq) * 32 + g * kHubLanes + li] = v;
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0)
          is_last = atomicAdd(counters + id, 1) == kHubGroups - 1;
        __syncthreads();
        if (is_last) {
          __threadfence();
          if (warp < QC && q0 + warp < q_cols) {
            Acc x = __ldcg(scratch + (id * QC + warp) * 32 + lane);
            x = warp_reduce<C>(x);
            if (lane == 0) epi.put(r, q0 + warp, q_cols, x);
          }
          if (threadIdx.x == 0) counters[id] = 0;
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
struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

inline std::mutex side_mutex;
inline SideStream side_streams[64];

inline cudaError_t side_stream(SideStream** out) {
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

// One call's block sizes: rows a row block (block_r) and log2 of the
// least hub size (block_e).
struct Blocks {
  int rows = kDefaultRows;
  int hub_min_shift = kDefaultHubShift;
};

// (block_e, block_r) -> Blocks; false unless block_r is a legal row count
// and block_e a power of two in [32, 2^20].
inline bool make_blocks(int block_e, int block_r, Blocks* out) {
  if (!legal_rows(block_r) || block_e < 32 || block_e > (1 << 20) ||
      (block_e & (block_e - 1)) != 0)
    return false;
  int s = 0;
  while ((1 << s) < block_e) ++s;
  out->rows = block_r;
  out->hub_min_shift = s;
  return true;
}

// The caller's hub scratch (device memory): lane partials and arrival
// counters, the counters zero.  Used on the side stream only.
struct HubScratch {
  void* partials = nullptr;
  long long partial_bytes = 0;
  int* counters = nullptr;
  long long num_counters = 0;
};

// Query columns a pass (launch_cols).
inline int col_chunk(int q_cols) {
  return q_cols == 1 ? 1 : (q_cols == 2 ? 2 : (q_cols <= 4 ? 4 : 8));
}

// The scratch a call needs: out[0] bytes of lane partials (acc_bytes an
// accumulator: 32 a multiple of H and column pass), out[1] counters (one
// a multiple and pass); 0 and 0 when the edge list holds no multiple.
inline void hub_scratch_size(long long num_edges, int q_cols, int min_shift,
                             int acc_bytes, long long* out) {
  const int shift = hub_shift(num_edges, min_shift);
  const int qc = col_chunk(q_cols);
  const long long multiples =
      num_edges > (1LL << shift) ? (num_edges - 1) >> shift : 0;
  const long long ids = multiples * ((q_cols + qc - 1) / qc);
  out[0] = ids * qc * 32 * acc_bytes;
  out[1] = ids;
}

// Both launches over rows [0, row_cap), rows [0, num_rows) reduced.
template <class Src, class Epi, int C, int QC, int kRows>
cudaError_t launch_both(cudaStream_t stream, const Src& source,
                        const Epi& epi, const int* dst, long long num_edges,
                        long long num_rows, long long row_cap, int q_cols,
                        int min_shift, const HubScratch& hs) {
  using Acc = typename Src::Acc;
  const dim3 grid(num_row_blocks(row_cap, kRows));
  const int cache = kCacheBytesPerRow * kRows;
  cudaError_t err = cudaSuccess;
  if (cache > 48 * 1024 &&
      (err = cudaFuncSetAttribute(row_kernel<Src, Epi, C, QC, kRows>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  cache)) != 0)
    return err;
  // hubs need a chunk of at least 32 edges
  const int shift = hub_shift(num_edges, min_shift);
  const bool hubs = source.hub_chunk_edges(q_cols) >= 32 &&
                    num_edges > (1LL << shift) && num_rows > 0;
  if (!hubs) {
    row_kernel<Src, Epi, C, QC, kRows><<<grid, kRows, cache, stream>>>(
        source, epi, dst, num_edges, num_rows, row_cap, q_cols, 0);
    return cudaGetLastError();
  }
  const long long multiples = (num_edges - 1) >> shift;
  const long long ids = multiples * ((q_cols + QC - 1) / QC);
  if (hs.partials == nullptr || hs.counters == nullptr ||
      hs.partial_bytes < ids * QC * 32 * static_cast<long long>(sizeof(Acc)) ||
      hs.num_counters < ids)
    return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(side_mutex);
  SideStream* side = nullptr;
  if ((err = side_stream(&side)) != cudaSuccess) return err;
  const int blocks =
      static_cast<int>(min(multiples, 1LL * kHubBlocks)) * kHubGroups;
  const int ring = kHubStages * (kHubChunkBytes + Src::kSlackBytes);
  if ((err = cudaFuncSetAttribute(hub_kernel<Src, Epi, C, QC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  ring)) != 0 ||
      (err = cudaEventRecord(side->fork, stream)) != 0 ||
      (err = cudaStreamWaitEvent(side->stream, side->fork, 0)) != 0)
    return err;
  hub_kernel<Src, Epi, C, QC><<<blocks, kHubThreads, ring, side->stream>>>(
      source, epi, dst, num_edges, num_rows, q_cols, shift,
      static_cast<Acc*>(hs.partials), hs.counters);
  if ((err = cudaGetLastError()) != 0) return err;
  row_kernel<Src, Epi, C, QC, kRows><<<grid, kRows, cache, stream>>>(
      source, epi, dst, num_edges, num_rows, row_cap, q_cols, shift);
  if ((err = cudaGetLastError()) != 0 ||
      (err = cudaEventRecord(side->join, side->stream)) != 0 ||
      (err = cudaStreamWaitEvent(stream, side->join, 0)) != 0)
    return err;
  return cudaSuccess;
}

template <class Src, class Epi, int C, int QC>
cudaError_t launch_rows(cudaStream_t stream, const Src& source,
                        const Epi& epi, const int* dst, long long num_edges,
                        long long num_rows, long long row_cap, int q_cols,
                        const Blocks& b, const HubScratch& hs) {
  switch (b.rows) {
    case 128:
      return launch_both<Src, Epi, C, QC, 128>(
          stream, source, epi, dst, num_edges, num_rows, row_cap, q_cols,
          b.hub_min_shift, hs);
    case 256:
      return launch_both<Src, Epi, C, QC, 256>(
          stream, source, epi, dst, num_edges, num_rows, row_cap, q_cols,
          b.hub_min_shift, hs);
    case 512:
      return launch_both<Src, Epi, C, QC, 512>(
          stream, source, epi, dst, num_edges, num_rows, row_cap, q_cols,
          b.hub_min_shift, hs);
    default:
      return cudaErrorInvalidValue;
  }
}

// Query columns in one pass of up to 8, at the call's block sizes.
template <class Src, class Epi, int C>
cudaError_t launch_cols(cudaStream_t stream, const Src& source,
                        const Epi& epi, const int* dst, long long num_edges,
                        long long num_rows, long long row_cap, int q_cols,
                        const Blocks& b, const HubScratch& hs) {
  switch (col_chunk(q_cols)) {
    case 1:
      return launch_rows<Src, Epi, C, 1>(stream, source, epi, dst, num_edges,
                                         num_rows, row_cap, q_cols, b, hs);
    case 2:
      return launch_rows<Src, Epi, C, 2>(stream, source, epi, dst, num_edges,
                                         num_rows, row_cap, q_cols, b, hs);
    case 4:
      return launch_rows<Src, Epi, C, 4>(stream, source, epi, dst, num_edges,
                                         num_rows, row_cap, q_cols, b, hs);
    default:
      return launch_rows<Src, Epi, C, 8>(stream, source, epi, dst, num_edges,
                                         num_rows, row_cap, q_cols, b, hs);
  }
}

}  // namespace seg
