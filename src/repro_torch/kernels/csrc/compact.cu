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
// Four launches on one stream, no atomics, deterministic:
//   1. count: each block counts the set entries of its kBlock elements
//      (__syncthreads_count per round of kThreads);
//   2. scan:  one block turns the block counts into exclusive offsets and
//      writes the total after them;
//   3. scatter: each block walks its elements again; an entry's position
//      is the block offset, plus the earlier rounds' counts, plus the
//      earlier warps' counts of this round (shared memory), plus
//      __popc(ballot & lanemask_lt).  Positions >= K are dropped, so a
//      popcount above K keeps the first K entries;
//   4. fill: slots from min(total, K) to K get (fill, 0).
//
// Bound on an H100: bytes.  It must read the mask (1 byte an element) and
// the values of the set entries, and write 8 bytes a slot: about
// V + 4·V + 8·K bytes at most — 34.4 MB, 10.3 µs at 3.35 TB/s, for
// V = 4,194,304 and K = 1,677,824.  The mask is read twice (count and
// scatter), a warp reading 32 consecutive bytes a round; the values are
// read only where set.  Values move as 32-bit words, so float32 and int32
// come out bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr long long kBlock = static_cast<long long>(kThreads) * kRounds;
constexpr int kScanThreads = 1024;
constexpr int kFillThreads = 256;
constexpr int kMaxFillBlocks = 4096;

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, long long n,
             int* __restrict__ counts) {
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  int c = 0;
  for (int j = 0; j < kRounds; ++j) {
    const long long i = base + static_cast<long long>(j) * kThreads +
                        threadIdx.x;
    c += __syncthreads_count(i < n && mask[i] != 0);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// counts[0, nblocks) -> exclusive offsets in place; counts[nblocks] = total.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ counts, int nblocks) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = (nblocks + kScanThreads - 1) / kScanThreads;
  const int begin = min(static_cast<int>(threadIdx.x) * chunk, nblocks);
  const int end = min(begin + chunk, nblocks);
  int s = 0;
  for (int i = begin; i < end; ++i) s += counts[i];
  int x = s;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = x - s + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = begin; i < end; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (threadIdx.x == kScanThreads - 1) counts[nblocks] = run;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ mask,
               const uint32_t* __restrict__ values, long long n,
               const int* __restrict__ offsets, long long capacity,
               int* __restrict__ out_idx, uint32_t* __restrict__ out_val) {
  __shared__ int warp_counts[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  long long offset = offsets[blockIdx.x];
  for (int j = 0; j < kRounds; ++j) {
    const long long r0 = base + static_cast<long long>(j) * kThreads;
    if (r0 >= n || offset >= capacity) break;  // uniform over the block
    const long long i = r0 + threadIdx.x;
    const bool set = i < n && mask[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, set);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_counts[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (set) {
      const long long pos = offset + before + __popc(ballot & lanemask_lt);
      if (pos < capacity) {
        out_idx[pos] = static_cast<int>(i);
        out_val[pos] = values[i];
      }
    }
    offset += total;
    __syncthreads();  // warp_counts is rewritten by the next round
  }
}

__global__ void __launch_bounds__(kFillThreads)
fill_kernel(const int* __restrict__ total, long long capacity, int fill,
            int* __restrict__ out_idx, uint32_t* __restrict__ out_val) {
  const long long start = min(static_cast<long long>(*total), capacity);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = start + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < capacity; k += stride) {
    out_idx[k] = fill;
    out_val[k] = 0u;
  }
}

long long num_blocks(long long n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// Length of the int32 scratch compact_u32 needs for n elements.
long long compact_scratch_len(long long n) { return num_blocks(n) + 1; }

// mask [n] uint8 (0 = unset), values [n] 32-bit words, out_idx int32 [K],
// out_val 32-bit words [K], scratch int32 [compact_scratch_len(n)].
// Returns the cudaError_t of the launches (0 = success).
int compact_u32(const uint8_t* mask, const uint32_t* values, long long n,
                long long capacity, int fill, int* out_idx,
                uint32_t* out_val, int* scratch, long long scratch_len,
                void* stream) {
  const long long nblocks = num_blocks(n);
  if (n < 0 || n > 2147483647LL || capacity < 0 ||
      scratch_len < nblocks + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(nblocks);
  if (nb > 0) count_kernel<<<nb, kThreads, 0, s>>>(mask, n, scratch);
  scan_kernel<<<1, kScanThreads, 0, s>>>(scratch, nb);
  if (nb > 0 && capacity > 0)
    scatter_kernel<<<nb, kThreads, 0, s>>>(mask, values, n, scratch,
                                           capacity, out_idx, out_val);
  if (capacity > 0) {
    const long long want = (capacity + kFillThreads - 1) / kFillThreads;
    const int grid = static_cast<int>(want < kMaxFillBlocks ? want
                                                             : kMaxFillBlocks);
    fill_kernel<<<grid, kFillThreads, 0, s>>>(scratch + nb, capacity, fill,
                                              out_idx, out_val);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
