// Stream compaction for the sparse broadcast payload — kernel 3.
//
// Replaces the TPU kernel repro/kernels/compact.py:compact_pallas
// (pallas_call at compact.py:107, body _kernel).  That kernel takes a
// prefix count per block, routes each index and value through f32 lanes of
// a one-hot MXU select (so it needs V < 2^24) and relies on the grid's
// sequential steps to let later blocks overwrite earlier padding.  Neither
// carries over: here indices are int32 throughout (any V < 2^31) and the
// blocks run in any order, so every output slot is written exactly once.
//
//   out_idx[k], out_val[k] = the k-th set index of mask [V] (ascending)
//                            and values[it], for k < min(popcount, K);
//                            (fill, 0) for the rest of the K slots.
//
// One launch, single pass, deterministic:
//   - A block takes a virtual id from an integer atomicAdd counter (so a
//     block only ever waits on blocks that have started) and, for ids
//     below the tile count, one tile of kTile mask bytes.  The tiles sit
//     on the 16-byte grid of the mask's address, so each thread reads 16
//     bytes at once per round; a chunk that runs past either end of the
//     mask (an unaligned view, V not a multiple of 16) is read byte by
//     byte.  Each chunk becomes a 16-bit set mask, counted with __popc.
//   - One block scan of the threads' counts (both rounds packed in one
//     int), then a decoupled look-back across tiles: the tile publishes
//     its count, warp 0 reads its predecessors' flags 32 at a time until
//     it meets an inclusive prefix, and the tile publishes its own.
//   - Each set entry's slot is the tile's prefix plus its rank; slots >= K
//     are dropped, so a popcount above K keeps the first K entries.
//   - Blocks with ids past the tiles wait for the last tile's prefix (the
//     total) and fill slots [min(total, K), K) with 16-byte stores.
// The atomic counter orders scheduling only; every slot's content is a
// function of the mask and values alone.
//
// Bound on an H100: bytes.  It must read the mask (1 byte an element) and
// the values of the set entries, and write 8 bytes a slot: V + 4·set + 8·K.
// The design reads the mask once, 16 bytes a thread, and the values only
// where set.  Values move as 32-bit words, so float32 and int32 come out
// bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                          // mask bytes a load
constexpr int kRounds = 2;                          // chunks a thread
constexpr long long kTile = static_cast<long long>(kThreads) * kChunk * kRounds;
constexpr int kFillSlots = kThreads * 4 * 4;        // slots a fill block, once
constexpr int kMaxFillBlocks = 1056;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ unsigned nibble(unsigned w) {
  // bytes != 0 -> 0x01 each; the multiply gathers the four bits at 21..24
  return (((__vcmpne4(w, 0u) & 0x01010101u) * 0x00204081u) >> 21) & 0xFu;
}

// Set mask of the 16 elements at virtual positions [u0, u0 + 16); element
// i = u - a, a = the mask's address modulo 16.
__device__ __forceinline__ unsigned chunk_bits(const uint8_t* __restrict__ mask,
                                               long long n, long long a,
                                               long long u0) {
  const long long i0 = u0 - a;
  if (i0 >= 0 && i0 + kChunk <= n) {
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(mask + i0));
    return nibble(w.x) | nibble(w.y) << 4 | nibble(w.z) << 8 |
           nibble(w.w) << 12;
  }
  unsigned bits = 0;
  for (int j = 0; j < kChunk; ++j) {
    const long long i = i0 + j;
    if (i >= 0 && i < n && mask[i] != 0) bits |= 1u << j;
  }
  return bits;
}

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* flags, long long t) {
  return *reinterpret_cast<const volatile unsigned long long*>(flags + t);
}
__device__ __forceinline__ void store_flag(unsigned long long* flags,
                                           long long t,
                                           unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(flags + t) = w;
}

// Sum of the counts of tiles [0, tile), by warp 0: reads 32 flags at once,
// nearest first, until one holds an inclusive prefix.
__device__ long long look_back(const unsigned long long* flags, long long tile) {
  const int lane = threadIdx.x & 31;
  long long sum = 0;
  long long top = tile - 1;                 // nearest predecessor not summed
  while (top >= 0) {
    const long long t = top - lane;
    unsigned long long w = t >= 0 ? load_flag(flags, t) : kPrefix;
    unsigned ready = __ballot_sync(0xffffffffu, w >= kAggregate);
    unsigned pre = __ballot_sync(0xffffffffu, w >= kPrefix);
    // lanes up to the first prefix (or all 32) must have published
    const unsigned need = pre ? (pre & (~pre + 1u)) * 2u - 1u : 0xffffffffu;
    if ((ready & need) != need) {
      __nanosleep(20);
      continue;
    }
    long long c = (need >> lane) & 1u ? static_cast<long long>(w & 0xffffffffu)
                                      : 0;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) c += __shfl_xor_sync(0xffffffffu, c, m);
    sum += c;
    if (pre) break;
    top -= 32;
  }
  return sum;
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ mask,
               const uint32_t* __restrict__ values, long long n, long long a,
               long long num_tiles, long long capacity, int fill,
               int* __restrict__ out_idx, uint32_t* __restrict__ out_val,
               unsigned long long* flags, unsigned int* counter) {
  __shared__ long long s_id;
  __shared__ int s_warp[kWarps];
  __shared__ long long s_base;
  if (threadIdx.x == 0) s_id = atomicAdd(counter, 1u);
  __syncthreads();
  const long long id = s_id;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (id >= num_tiles) {                    // fill block
    if (threadIdx.x == 0) {
      unsigned long long w = num_tiles > 0 ? 0 : kPrefix;
      while (w < kPrefix) {
        w = load_flag(flags, num_tiles - 1);
        if (w < kPrefix) __nanosleep(100);
      }
      s_base = static_cast<long long>(w & 0xffffffffu);
    }
    __syncthreads();
    const long long start = min(s_base, capacity);
    const long long fid = id - num_tiles;
    const long long nfill = gridDim.x - num_tiles;
    const long long stride = nfill * kThreads;
    const bool vec = reinterpret_cast<uintptr_t>(out_idx) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out_val) % 16 == 0;
    // [start, head) and [body_end, K) scalar, [head, body_end) 16 bytes
    long long head = capacity, body_end = capacity;
    if (vec) {
      head = min((start + 3) & ~3LL, capacity);
      body_end = head + ((capacity - head) & ~3LL);
    }
    const long long me = fid * kThreads + threadIdx.x;
    const int4 fi = make_int4(fill, fill, fill, fill);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (long long k = head + 4 * me; k < body_end; k += 4 * stride) {
      __stcs(reinterpret_cast<int4*>(out_idx + k), fi);
      __stcs(reinterpret_cast<uint4*>(out_val + k), zero);
    }
    if (fid == 0) {                         // scalar head and tail
      for (long long k = start + threadIdx.x; k < head; k += kThreads) {
        out_idx[k] = fill;
        out_val[k] = 0u;
      }
      for (long long k = body_end + threadIdx.x; k < capacity;
           k += kThreads) {
        out_idx[k] = fill;
        out_val[k] = 0u;
      }
    }
    return;
  }

  // Scan tile: round r's chunk of thread t is chunk r * kThreads + t.
  const long long u_tile = id * kTile;
  unsigned bits[kRounds];
  int packed = 0;                           // round 0 count | round 1 << 16
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    bits[r] = chunk_bits(mask, n, a,
                         u_tile + (static_cast<long long>(r) * kThreads +
                                   threadIdx.x) * kChunk);
    packed += __popc(bits[r]) << (16 * r);
  }
  int incl = packed;                        // block scan of the packed counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = s_warp[w];
    before += w < warp ? s : 0;
    total += s;
  }
  const int excl = incl - packed + before;
  const int total0 = total & 0xFFFF;
  const long long agg = total0 + (total >> 16);

  if (warp == 0) {
    long long prefix = 0;
    if (id == 0) {
      if (lane == 0) store_flag(flags, 0, kPrefix | agg);
    } else {
      if (lane == 0) store_flag(flags, id, kAggregate | agg);
      prefix = look_back(flags, id);
      if (lane == 0) store_flag(flags, id, kPrefix | (prefix + agg));
    }
    if (lane == 0) s_base = prefix;
  }
  __syncthreads();
  const long long base = s_base;
  if (base >= capacity) return;

  int rank[kRounds] = {excl & 0xFFFF, total0 + (excl >> 16)};
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long u0 =
        u_tile + (static_cast<long long>(r) * kThreads + threadIdx.x) * kChunk;
    for (unsigned b = bits[r]; b; b &= b - 1) {
      const long long pos = base + rank[r]++;
      if (pos >= capacity) break;
      const long long i = u0 + (__ffs(b) - 1) - a;
      out_idx[pos] = static_cast<int>(i);
      out_val[pos] = values[i];
    }
  }
}

// Tiles for n elements whose first sits at offset a of a 16-byte line.
long long num_tiles(long long n, long long a) {
  return n > 0 ? (n + a + kTile - 1) / kTile : 0;
}

}  // namespace

extern "C" {

// Length of the int32 scratch compact_u32 needs for n elements (any mask
// address): two words a tile for the look-back flags, two for the counter.
// The caller zeroes it before each call.
long long compact_scratch_len(long long n) {
  return 2 * num_tiles(n, kChunk - 1) + 2;
}

// mask [n] uint8 (0 = unset), values [n] 32-bit words, out_idx int32 [K],
// out_val 32-bit words [K], scratch int32 [compact_scratch_len(n)], zeroed
// and 8-byte aligned.  Returns the cudaError_t of the launch (0 = success).
int compact_u32(const uint8_t* mask, const uint32_t* values, long long n,
                long long capacity, int fill, int* out_idx,
                uint32_t* out_val, int* scratch, long long scratch_len,
                void* stream) {
  const long long a = static_cast<long long>(
      reinterpret_cast<uintptr_t>(mask) % kChunk);
  const long long tiles = num_tiles(n, a);
  if (n < 0 || n > 2147483647LL || capacity < 0 ||
      scratch_len < 2 * tiles + 2 ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (capacity == 0) return static_cast<int>(cudaSuccess);
  const long long want = (capacity + kFillSlots - 1) / kFillSlots;
  const long long fills = want < kMaxFillBlocks ? want : kMaxFillBlocks;
  unsigned long long* flags = reinterpret_cast<unsigned long long*>(scratch);
  unsigned int* counter = reinterpret_cast<unsigned int*>(scratch + 2 * tiles);
  compact_kernel<<<static_cast<unsigned int>(tiles + fills), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      mask, values, n, a, tiles, capacity, fill, out_idx, out_val, flags,
      counter);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
