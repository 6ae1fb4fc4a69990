// Shared pieces of the two GAB segment kernels (segment_reduce.cu,
// gab_fused.cu): the legal row-block sizes, the combine monoids, a binary
// search on the dst-sorted edge list and the fixed-order warp reduction.
// Their common row layout is seg_layout.cuh.
//
// Determinism: a row's edges are combined in one fixed order (lane l of a
// warp takes edges lo + l, lo + l + 32, ..., then a butterfly over the
// lanes; seg_layout.cuh).  No atomics on values: each row's result is
// formed once.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace seg {

// A row block owns kRows consecutive rows, one thread a row (kRows / 32
// warps); kRows is chosen at run time from {128, 256, 512} (the tuner's
// block_r, roofline/kernel_tune.py), 256 by default.  Which block owns a
// row changes no bit of its result (seg_layout.cuh).
constexpr int kDefaultRows = 256;
inline bool legal_rows(int rows) {
  return rows == 128 || rows == 256 || rows == 512;
}

enum Combine { kSum = 0, kMin = 1, kMax = 2 };

// First index i in dst[0, n) with dst[i] >= key; dst is ascending.
__device__ __forceinline__ long long lower_bound(const int* __restrict__ dst,
                                                 long long n, long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (static_cast<long long>(dst[mid]) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// NaN-propagating min / max, as torch.minimum / jnp.minimum.
__device__ __forceinline__ float min_nan(float x, float y) {
  if (x != x || y != y) return CUDART_NAN_F;
  return y < x ? y : x;
}
__device__ __forceinline__ float max_nan(float x, float y) {
  if (x != x || y != y) return CUDART_NAN_F;
  return y > x ? y : x;
}

template <int C> __device__ __forceinline__ float combine(float x, float y) {
  if (C == kSum) return __fadd_rn(x, y);
  if (C == kMin) return min_nan(x, y);
  return max_nan(x, y);
}
template <int C>
__device__ __forceinline__ long long combine(long long x, long long y) {
  if (C == kSum) return x + y;
  if (C == kMin) return y < x ? y : x;
  return y > x ? y : x;
}

// Identity of the monoid, for the output type T.
template <typename T, int C> struct Identity;
template <int C> struct Identity<float, C> {
  __device__ static float value() {
    return C == kSum ? 0.0f : (C == kMin ? CUDART_INF_F : -CUDART_INF_F);
  }
};
template <int C> struct Identity<int, C> {
  __device__ static long long value() {
    return C == kSum ? 0LL : (C == kMin ? 2147483647LL : -2147483648LL);
  }
};
template <int C> struct Identity<long long, C> {
  __device__ static long long value() {
    return C == kSum ? 0LL
                     : (C == kMin ? 9223372036854775807LL
                                  : (-9223372036854775807LL - 1));
  }
};

// Butterfly over the 32 lanes; every lane ends with the same value (each
// step combines the same two operands on both partner lanes).
template <int C, typename Acc>
__device__ __forceinline__ Acc warp_reduce(Acc v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    v = combine<C>(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

inline unsigned int num_row_blocks(long long rows, int rows_per_block) {
  return static_cast<unsigned int>((rows + rows_per_block - 1) /
                                   rows_per_block);
}

}  // namespace seg

extern "C" const char* repro_cuda_error_string(int code);
