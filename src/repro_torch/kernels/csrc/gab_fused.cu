// Fused gather -> combine -> apply -> mask tile step — kernel 2 of the GAB
// loop.
//
// Replaces the TPU kernel repro/kernels/gab_fused.py:gab_fused (pallas_call
// at gab_fused.py:294, body _kernel).  That kernel streams edge blocks
// HBM->VMEM through a two-slot DMA buffer into a one-hot MXU contraction
// per row block and applies the vertex update before one write-back.  The
// one-hot form costs Q·E·R work per tile; here the tile's dst_local is
// CSR-sorted, so each row owns a contiguous edge range.
//
// Per row r < row_cap and query column q:
//   msg  = src[e, q] (* a[e]) (+ b[e]) (+ add_const)      for dst[e] == r
//   acc  = (+|min|max) over the row's messages (identity when none)
//   new  = alpha * base[r, q] + beta * acc    (base 1.0 when absent)
//        | min(old, acc) | max(old, acc)
//   rows r >= num_rows keep old; updated = valid && (|new-old| > tol | !=)
//
// Layout: one block per kRowsPerBlock rows, row edge ranges by binary
// search on dst (as segment_reduce.cu), one warp per row; the message is
// formed in registers and never written out, and the apply and the mask
// run in the epilogue, so new and updated are written once.
//
// Bound on an H100: bytes.  Per edge the kernel must read src (4·Q bytes)
// and each of a, b (4 bytes); per row old (+ base) and write new and
// updated.  A handful of flops per edge is far below the card's rate.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, and the library is built with -fmad=false), so the message
// and the affine apply agree bit for bit with the plain PyTorch version,
// which computes them as separate operations.  Only the order of the sum
// over a row differs from it.
#include "seg_common.cuh"

using namespace seg;

enum Apply { kAffine = 0, kApplyMin = 1, kApplyMax = 2 };

template <int C, int A>
__global__ void __launch_bounds__(kThreads)
gab_fused_kernel(const float* __restrict__ src, const float* __restrict__ a,
                 const float* __restrict__ b, const int* __restrict__ dst,
                 const float* __restrict__ old,
                 const float* __restrict__ base, float* __restrict__ out_new,
                 uint8_t* __restrict__ out_upd, long long num_edges,
                 long long row_cap, int q_cols, long long num_rows,
                 int has_const, float add_const, float alpha, float beta,
                 float tol) {
  __shared__ long long bounds[kRowsPerBlock + 1];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  block_row_bounds(dst, num_edges, r0, bounds);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < kRowsPerBlock; i += kWarps) {
    const long long r = r0 + i;
    if (r >= row_cap) break;
    const long long lo = bounds[i];
    const long long hi = bounds[i + 1];
    for (int q = 0; q < q_cols; ++q) {
      float acc = Identity<float, C>::value();
      for (long long e = lo + lane; e < hi; e += 32) {
        float msg = src[e * q_cols + q];
        if (a != nullptr) msg = __fmul_rn(msg, a[e]);
        if (b != nullptr) msg = __fadd_rn(msg, b[e]);
        if (has_const) msg = __fadd_rn(msg, add_const);
        acc = combine<C>(acc, msg);
      }
      acc = warp_reduce<C>(acc);
      if (lane == 0) {
        const long long k = r * q_cols + q;
        const float o = old[k];
        float nv;
        if (A == kAffine) {
          nv = base != nullptr
                   ? __fadd_rn(__fmul_rn(alpha, base[k]), __fmul_rn(beta, acc))
                   : __fadd_rn(alpha, __fmul_rn(beta, acc));
        } else if (A == kApplyMin) {
          nv = min_nan(o, acc);
        } else {
          nv = max_nan(o, acc);
        }
        const bool valid = r < num_rows;
        if (!valid) nv = o;
        const bool changed =
            tol > 0.0f ? fabsf(__fsub_rn(nv, o)) > tol : nv != o;
        out_new[k] = nv;
        out_upd[k] = (valid && changed) ? 1 : 0;
      }
    }
  }
}

template <int C>
static int launch_apply(int apply_code, dim3 grid, cudaStream_t stream,
                        const float* src, const float* a, const float* b,
                        const int* dst, const float* old, const float* base,
                        float* out_new, uint8_t* out_upd, long long num_edges,
                        long long row_cap, int q_cols, long long num_rows,
                        int has_const, float add_const, float alpha,
                        float beta, float tol) {
#define REPRO_GAB_FUSED_LAUNCH(APPLY)                                       \
  gab_fused_kernel<C, APPLY><<<grid, kThreads, 0, stream>>>(                \
      src, a, b, dst, old, base, out_new, out_upd, num_edges, row_cap,      \
      q_cols, num_rows, has_const, add_const, alpha, beta, tol)
  switch (apply_code) {
    case kAffine: REPRO_GAB_FUSED_LAUNCH(kAffine); break;
    case kApplyMin: REPRO_GAB_FUSED_LAUNCH(kApplyMin); break;
    case kApplyMax: REPRO_GAB_FUSED_LAUNCH(kApplyMax); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_GAB_FUSED_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// src [E, Q], old/base/out_new/out_upd [row_cap, Q] row-major; a, b [E] or
// NULL; base NULL for the implicit 1.0; dst [E] ascending int32.  Returns
// the cudaError_t of the launch (0 = success).
int gab_fused_f32(const float* src, const float* a, const float* b,
                  const int* dst, const float* old, const float* base,
                  float* out_new, uint8_t* out_upd, long long num_edges,
                  long long row_cap, int q_cols, long long num_rows,
                  int combine_code, int apply_code, int has_const,
                  float add_const, float alpha, float beta, float tol,
                  void* stream) {
  const dim3 grid(num_row_blocks(row_cap));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (combine_code) {
    case kSum:
      return launch_apply<kSum>(apply_code, grid, s, src, a, b, dst, old,
                                base, out_new, out_upd, num_edges, row_cap,
                                q_cols, num_rows, has_const, add_const, alpha,
                                beta, tol);
    case kMin:
      return launch_apply<kMin>(apply_code, grid, s, src, a, b, dst, old,
                                base, out_new, out_upd, num_edges, row_cap,
                                q_cols, num_rows, has_const, add_const, alpha,
                                beta, tol);
    case kMax:
      return launch_apply<kMax>(apply_code, grid, s, src, a, b, dst, old,
                                base, out_new, out_upd, num_edges, row_cap,
                                q_cols, num_rows, has_const, add_const, alpha,
                                beta, tol);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
