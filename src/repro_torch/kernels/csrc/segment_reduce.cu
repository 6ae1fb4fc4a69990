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
// Layout: one block owns kRowsPerBlock consecutive rows; its threads find
// the rows' edge ranges by binary search on dst (shared memory), then each
// warp reduces one row at a time — lanes stride the row's edges in order,
// a fixed butterfly combines the lanes — over every query column.  Empty
// rows get the identity.  No atomics, fixed order: deterministic.
//
// Bound on an H100: bytes.  The kernel must read contrib (4·Q bytes per
// edge) and write out (4·Q bytes per row), a few flops per edge; the design
// reads each contribution once, coalesced across a warp for Q = 1, and
// never reads dst per edge (only the binary searches touch it).  Rows with
// huge in-degree serialise on one warp; that is the known weak spot.
//
// Integer contributions (int32, int64) reduce in int64 — exact sums — and
// are cast back to their own type.
#include "seg_common.cuh"

using namespace seg;

template <typename T, typename Acc, int C>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const T* __restrict__ contrib,
                      const int* __restrict__ dst, T* __restrict__ out,
                      long long num_edges, long long num_rows, int q_cols) {
  __shared__ long long bounds[kRowsPerBlock + 1];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  block_row_bounds(dst, num_edges, r0, bounds);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < kRowsPerBlock; i += kWarps) {
    const long long r = r0 + i;
    if (r >= num_rows) break;
    const long long lo = bounds[i];
    const long long hi = bounds[i + 1];
    for (int q = 0; q < q_cols; ++q) {
      Acc acc = Identity<T, C>::value();
      for (long long e = lo + lane; e < hi; e += 32)
        acc = combine<C>(acc, static_cast<Acc>(contrib[e * q_cols + q]));
      acc = warp_reduce<C>(acc);
      if (lane == 0) out[r * q_cols + q] = static_cast<T>(acc);
    }
  }
}

template <typename T, typename Acc>
static int launch(const T* contrib, const int* dst, T* out,
                  long long num_edges, long long num_rows, int q_cols,
                  int combine_code, cudaStream_t stream) {
  const dim3 grid(num_row_blocks(num_rows));
  switch (combine_code) {
    case kSum:
      segment_reduce_kernel<T, Acc, kSum><<<grid, kThreads, 0, stream>>>(
          contrib, dst, out, num_edges, num_rows, q_cols);
      break;
    case kMin:
      segment_reduce_kernel<T, Acc, kMin><<<grid, kThreads, 0, stream>>>(
          contrib, dst, out, num_edges, num_rows, q_cols);
      break;
    case kMax:
      segment_reduce_kernel<T, Acc, kMax><<<grid, kThreads, 0, stream>>>(
          contrib, dst, out, num_edges, num_rows, q_cols);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// contrib [E, Q] and out [R, Q] row-major, dst [E] ascending int32.
// Returns the cudaError_t of the launch (0 = success).
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
