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
// Layout: seg_layout.cuh's, the segment kernel's (segment_reduce.cu) —
// short rows packed many to a warp, long rows on a whole warp, hub rows in
// a second launch on a side stream — with two policies:
// - source: the message, formed as an edge is loaded.  A row block copies
//   its slice's src (4·Q bytes an edge) and a, b (4 bytes each, when
//   present) into shared memory with cp.async; one lane takes all Q
//   columns of an edge, so a and b are read once an edge, not once a
//   column.  Hub rows hold two multiples of H edges (H = block_e, 256 by
//   default, at a tile's size), and four blocks stream each, eight lanes
//   a block: a row
//   block streams all its rows through one SM, and an a or b stream
//   doubles the bytes of an edge at Q = 1, so at a tile every row of more
//   than 512 edges leaves the row blocks and spreads over four SMs;
// - epilogue: the lane that ends up with a row's result runs the apply
//   and the mask and writes new and updated once.  Rows at or past
//   num_rows are never reduced: the row blocks' slices end at the first
//   edge with dst >= num_rows, the hub search skips such rows (the tile's
//   padding edges all point at num_rows, and would otherwise form one long
//   sink row), and a block copies old -> new and zeroes updated for its
//   rows past num_rows in 16-byte moves — the whole block's work when it
//   lies past num_rows, as most of a tile's row_cap does.
// A row's sum therefore runs in exactly the segment kernel's order, which
// the engine's merged mode (segment kernel, then the apply in PyTorch)
// needs to equal the tiled mode (this kernel) bit for bit.  No atomics on
// values (a hub's four blocks meet at an integer counter); deterministic.
//
// Bound on an H100: bytes.  Per edge the kernel must read src (4·Q bytes),
// dst (4 bytes) and each of a, b (4 bytes); per row old (+ base) and write
// new and updated.  A handful of flops per edge is far below the card's
// rate.  The design reads each about once (Q <= 8), coalesced, and does
// no work for rows past num_rows beyond the copy.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, and the library is built with -fmad=false), so the message
// and the affine apply agree bit for bit with the plain PyTorch version,
// which computes them as separate operations.  Only the order of the sum
// over a row differs from it.
#include "seg_layout.cuh"

using namespace seg;

namespace fused {

enum Apply { kAffine = 0, kApplyMin = 1, kApplyMax = 2 };

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

// Source: the message src·a + b + add_const, up to three streams an edge.
struct MessageSource {
  using Val = float;
  using Acc = float;
  // each stream's region: its values rounded up to 16 bytes, plus the
  // copy's line padding
  static constexpr int kSlackBytes = 3 * 32;
  const float* src;
  const float* a;                         // or NULL
  const float* b;                         // or NULL
  float add_const;
  bool has_const;

  struct Staged {
    const float* s;                       // edge e0 + i at s[i * q_cols]
    const float* a;                       // edge e0 + i at a[i]
    const float* b;
    bool aligned;                         // s on the 16-byte grid
  };
  __host__ __device__ int streams(int q_cols) const {
    return q_cols + (a != nullptr) + (b != nullptr);
  }
  __host__ __device__ int edge_bytes(int q_cols) const {
    return 4 * streams(q_cols);
  }
  // edges a hub chunk spans: a group stages 1 / kHubGroups of them
  __host__ __device__ long long hub_chunk_edges(int q_cols) const {
    return (1LL * kHubChunkBytes / 4 / streams(q_cols) * kHubGroups) & ~31LL;
  }
  // Regions of `count` edges from smem on: src, then a, then b.
  __device__ Staged staged(unsigned char* smem, long long e0, int count,
                           int q_cols) const {
    const float* to = reinterpret_cast<const float*>(smem);
    const float* from = src + e0 * q_cols;
    Staged st{to + line_pad(from), nullptr, nullptr, line_pad(from) == 0};
    to += round_up4(count * q_cols) + 4;
    if (a != nullptr) {
      st.a = to + line_pad(a + e0);
      to += round_up4(count) + 4;
    }
    if (b != nullptr) st.b = to + line_pad(b + e0);
    return st;
  }
  __device__ Staged stage(unsigned char* smem, long long e0, int count,
                          int q_cols) const {
    float* to = reinterpret_cast<float*>(smem);
    copy_async(to, src + e0 * q_cols, count * q_cols);
    to += round_up4(count * q_cols) + 4;
    if (a != nullptr) {
      copy_async(to, a + e0, count);
      to += round_up4(count) + 4;
    }
    if (b != nullptr) copy_async(to, b + e0, count);
    return staged(smem, e0, count, q_cols);
  }
  // Group g's edges of the hub chunk [c0, c0 + count) (copy_runs), staged
  // edge i at s[i·Q], a[i], b[i] — src, then a, then b, each region
  // 16-byte aligned.
  __device__ Staged staged_hub(unsigned char* smem, long long, int count,
                               int, int q_cols) const {
    const int n = (count + 31) / 32 * kHubLanes;
    float* to = reinterpret_cast<float*>(smem);
    Staged st{to, nullptr, nullptr, true};
    to += round_up4(n * q_cols);
    if (a != nullptr) {
      st.a = to;
      to += round_up4(n);
    }
    if (b != nullptr) st.b = to;
    return st;
  }
  __device__ Staged stage_hub(unsigned char* smem, long long c0, int count,
                              int g, int q_cols) const {
    const Staged st = staged_hub(smem, c0, count, g, q_cols);
    const int runs = (count + 31) / 32;
    const long long e0 = c0 + g * kHubLanes;
    copy_runs(const_cast<float*>(st.s), src, e0, runs, q_cols, c0 + count);
    if (a != nullptr) copy_runs(const_cast<float*>(st.a), a, e0, runs, 1,
                                c0 + count);
    if (b != nullptr) copy_runs(const_cast<float*>(st.b), b, e0, runs, 1,
                                c0 + count);
    return st;
  }
  __device__ __forceinline__ float message(float x, float av,
                                           float bv) const {
    if (a != nullptr) x = __fmul_rn(x, av);
    if (b != nullptr) x = __fadd_rn(x, bv);
    if (has_const) x = __fadd_rn(x, add_const);
    return x;
  }
  template <int QC>
  __device__ __forceinline__ void load(const Staged& st, long long e,
                                       long long e0, long long cached,
                                       int q0, int q_cols, float* v) const {
    const bool vec = q_cols % 4 == 0 && q0 % 4 == 0 && q0 + QC <= q_cols;
    float av = 1.0f, bv = 0.0f;
    const long long i = e - e0;
    if (i < cached) {
      load_cols<float, QC, false>(st.s + i * q_cols + q0, q_cols - q0,
                                  vec && st.aligned, v);
      if (a != nullptr) av = st.a[i];
      if (b != nullptr) bv = st.b[i];
    } else {
      load_cols<float, QC, true>(src + e * q_cols + q0, q_cols - q0,
                                 vec && line_pad(src) == 0, v);
      if (a != nullptr) av = __ldg(a + e);
      if (b != nullptr) bv = __ldg(b + e);
    }
#pragma unroll
    for (int q = 0; q < QC; ++q) v[q] = message(v[q], av, bv);
  }
  __device__ __forceinline__ float hub_value(const Staged& st, int i, int col,
                                             int q_cols) const {
    return message(st.s[i * q_cols + col], a != nullptr ? st.a[i] : 1.0f,
                   b != nullptr ? st.b[i] : 0.0f);
  }
};

// Epilogue: the apply and the updated mask of a reduced row; old -> new
// and updated = 0 for the rows past num_rows.
struct ApplyEpilogue {
  static constexpr bool kKeepsOld = true;
  const float* old;
  const float* base;                      // or NULL for the implicit 1.0
  float* out_new;
  uint8_t* out_upd;
  int apply;
  float alpha, beta, tol;

  __device__ __forceinline__ void put(long long r, int q, int q_cols,
                                      float acc) const {
    const long long k = r * q_cols + q;
    const float o = __ldg(old + k);
    float nv;
    if (apply == kAffine) {
      nv = base != nullptr
               ? __fadd_rn(__fmul_rn(alpha, __ldg(base + k)),
                           __fmul_rn(beta, acc))
               : __fadd_rn(alpha, __fmul_rn(beta, acc));
    } else if (apply == kApplyMin) {
      nv = min_nan(o, acc);
    } else {
      nv = max_nan(o, acc);
    }
    out_new[k] = nv;
    out_upd[k] = (tol > 0.0f ? fabsf(__fsub_rn(nv, o)) > tol : nv != o);
  }
  // Entries [k0, k1) belong to rows past num_rows: new = old, updated =
  // 0, in 16-byte moves where the arrays allow.  All threads of the block.
  __device__ void keep(long long k0, long long k1) const {
    if (k0 >= k1) return;
    const long long n = k1 - k0;
    const float* from = old + k0;
    float* to = out_new + k0;
    const long long head =
        line_pad(from) == line_pad(to) ? min((4LL - line_pad(to)) % 4, n) : n;
    const long long groups = (n - head) / 4;
    const int nt = blockDim.x;
    for (long long i = threadIdx.x; i < head; i += nt)
      to[i] = __ldg(from + i);
    for (long long g = threadIdx.x; g < groups; g += nt)
      reinterpret_cast<float4*>(to + head)[g] =
          __ldg(reinterpret_cast<const float4*>(from + head) + g);
    for (long long i = head + 4 * groups + threadIdx.x; i < n; i += nt)
      to[i] = __ldg(from + i);
    uint8_t* upd = out_upd + k0;
    const long long uhead =
        min((16LL - static_cast<long long>(line_pad(upd))) % 16, n);
    const long long ugroups = (n - uhead) / 16;
    for (long long i = threadIdx.x; i < uhead; i += nt) upd[i] = 0;
    for (long long g = threadIdx.x; g < ugroups; g += nt)
      reinterpret_cast<uint4*>(upd + uhead)[g] = make_uint4(0, 0, 0, 0);
    for (long long i = uhead + 16 * ugroups + threadIdx.x; i < n; i += nt)
      upd[i] = 0;
  }
};

template <int C>
int launch(const MessageSource& source, const ApplyEpilogue& epi,
           const int* dst, long long num_edges, long long num_rows,
           long long row_cap, int q_cols, const Blocks& b,
           const HubScratch& hs, cudaStream_t stream) {
  return static_cast<int>(launch_cols<MessageSource, ApplyEpilogue, C>(
      stream, source, epi, dst, num_edges, num_rows, row_cap, q_cols, b,
      hs));
}

}  // namespace fused

extern "C" {

// src [E, Q], old/base/out_new/out_upd [row_cap, Q] row-major; a, b [E] or
// NULL; base NULL for the implicit 1.0; dst [E] ascending int32.  block_e
// is the least hub size (a power of two), block_r the rows a row block
// (128, 256 or 512); partials (partial_bytes) and counters (num_counters,
// zero) the hub launch's scratch, as gab_fused_hub_scratch() sizes it.
// Returns the cudaError_t of the launches (0 = success).
int gab_fused_f32(const float* src, const float* a, const float* b,
                  const int* dst, const float* old, const float* base,
                  float* out_new, uint8_t* out_upd, long long num_edges,
                  long long row_cap, int q_cols, long long num_rows,
                  int combine_code, int apply_code, int has_const,
                  float add_const, float alpha, float beta, float tol,
                  int block_e, int block_r, void* partials,
                  long long partial_bytes, int* counters,
                  long long num_counters, void* stream) {
  using namespace fused;
  Blocks blocks;
  if (apply_code < kAffine || apply_code > kApplyMax ||
      !make_blocks(block_e, block_r, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const HubScratch hs{partials, partial_bytes, counters, num_counters};
  num_rows = num_rows < 0 ? 0 : (num_rows > row_cap ? row_cap : num_rows);
  const MessageSource source{src, a, b, add_const, has_const != 0};
  const ApplyEpilogue epi{old, base, out_new, out_upd, apply_code,
                          alpha, beta, tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (combine_code) {
    case kSum:
      return launch<kSum>(source, epi, dst, num_edges, num_rows, row_cap,
                          q_cols, blocks, hs, s);
    case kMin:
      return launch<kMin>(source, epi, dst, num_edges, num_rows, row_cap,
                          q_cols, blocks, hs, s);
    case kMax:
      return launch<kMax>(source, epi, dst, num_edges, num_rows, row_cap,
                          q_cols, blocks, hs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[0] bytes of hub partials and out[1] counters a call over num_edges
// edges and q_cols columns needs at least hub size block_e; -1 and -1 for
// an illegal block_e.
void gab_fused_hub_scratch(long long num_edges, int q_cols, int block_e,
                           long long* out) {
  Blocks b;
  if (!make_blocks(block_e, kDefaultRows, &b)) {
    out[0] = out[1] = -1;
    return;
  }
  hub_scratch_size(num_edges, q_cols, b.hub_min_shift, sizeof(float), out);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
