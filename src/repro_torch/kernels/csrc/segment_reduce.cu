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
// The layout is seg_layout.cuh's — a row launch that packs short rows
// many to a warp and a hub launch on a side stream — with the stored
// contributions as its source and a plain store as its epilogue; the
// order of a row's float sum is therefore gab_fused.cu's, bit for bit.
//
// Bound on an H100: bytes.  The kernel must read contrib (4·Q bytes per
// edge) and dst (4 bytes per edge) and write out (4·Q bytes per row); the
// design reads each about once (Q <= 8), coalesced.
//
// Integer contributions (int32, int64) reduce in int64 — exact sums — and
// are cast back to their own type.  Ids outside [0, R) are dropped: they
// sort before row 0 or after row R - 1, outside every block's slice.
#include "seg_layout.cuh"

using namespace seg;

namespace segment {


// Source: contrib [E, Q], one stream of Q values an edge.
template <typename T, typename AccT>
struct StoredSource {
  using Val = T;
  using Acc = AccT;
  static constexpr int kSlackBytes = 16;  // the copy's line padding
  const T* contrib;

  struct Staged {
    const T* vals;                        // edge e0 + i at vals[i * q_cols]
    bool aligned;                         // vals on the 16-byte grid
  };
  __host__ __device__ int edge_bytes(int q_cols) const {
    return q_cols * static_cast<int>(sizeof(T));
  }
  // edges a hub chunk spans: a group stages 1 / kHubGroups of them
  __host__ __device__ long long hub_chunk_edges(int q_cols) const {
    return (1LL * kHubChunkBytes / static_cast<int>(sizeof(T)) / q_cols *
            kHubGroups) & ~31LL;
  }
  __device__ Staged staged(unsigned char* smem, long long e0, int,
                           int q_cols) const {
    const int pad = line_pad(contrib + e0 * q_cols);
    return Staged{reinterpret_cast<const T*>(smem) + pad, pad == 0};
  }
  __device__ Staged stage(unsigned char* smem, long long e0, int count,
                          int q_cols) const {
    copy_async(reinterpret_cast<T*>(smem), contrib + e0 * q_cols,
               count * q_cols);
    return staged(smem, e0, count, q_cols);
  }
  // Group g's edges of the hub chunk [c0, c0 + count) (copy_runs),
  // staged edge i at vals[i·Q]
  __device__ Staged staged_hub(unsigned char* smem, long long, int, int,
                               int) const {
    return Staged{reinterpret_cast<const T*>(smem), true};
  }
  __device__ Staged stage_hub(unsigned char* smem, long long c0, int count,
                              int g, int q_cols) const {
    copy_runs(reinterpret_cast<T*>(smem), contrib, c0 + g * kHubLanes,
              (count + 31) / 32, q_cols, c0 + count);
    return staged_hub(smem, c0, count, g, q_cols);
  }
  template <int QC>
  __device__ __forceinline__ void load(const Staged& st, long long e,
                                       long long e0, long long cached,
                                       int q0, int q_cols, T* v) const {
    const bool vec = edge_bytes(q_cols) % 16 == 0 &&
                     (q0 * sizeof(T)) % 16 == 0 && q0 + QC <= q_cols;
    if (e - e0 < cached)
      load_cols<T, QC, false>(st.vals + (e - e0) * q_cols + q0, q_cols - q0,
                              vec && st.aligned, v);
    else
      load_cols<T, QC, true>(contrib + e * q_cols + q0, q_cols - q0,
                             vec && line_pad(contrib) == 0, v);
  }
  __device__ __forceinline__ Acc hub_value(const Staged& st, int i, int col,
                                           int q_cols) const {
    return static_cast<Acc>(st.vals[i * q_cols + col]);
  }
};

// Epilogue: out[r, q] = the row's value, cast back to T.
template <typename T, typename Acc>
struct StoreEpilogue {
  static constexpr bool kKeepsOld = false;
  T* out;

  __device__ __forceinline__ void put(long long r, int q, int q_cols,
                                      Acc v) const {
    out[r * q_cols + q] = static_cast<T>(v);
  }
};

template <typename T, typename Acc>
int launch(const T* contrib, const int* dst, T* out, long long num_edges,
           long long num_rows, int q_cols, int combine_code, int block_e,
           int block_r, void* partials, long long partial_bytes,
           int* counters, long long num_counters, cudaStream_t stream) {
  const StoredSource<T, Acc> source{contrib};
  const StoreEpilogue<T, Acc> epi{out};
  using S = StoredSource<T, Acc>;
  using E = StoreEpilogue<T, Acc>;
  Blocks b;
  if (!make_blocks(block_e, block_r, &b))
    return static_cast<int>(cudaErrorInvalidValue);
  const HubScratch hs{partials, partial_bytes, counters, num_counters};
  cudaError_t err;
  switch (combine_code) {
    case kSum:
      err = launch_cols<S, E, kSum>(stream, source, epi, dst, num_edges,
                                    num_rows, num_rows, q_cols, b, hs);
      break;
    case kMin:
      err = launch_cols<S, E, kMin>(stream, source, epi, dst, num_edges,
                                    num_rows, num_rows, q_cols, b, hs);
      break;
    case kMax:
      err = launch_cols<S, E, kMax>(stream, source, epi, dst, num_edges,
                                    num_rows, num_rows, q_cols, b, hs);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace segment

using segment::launch;

extern "C" {

// contrib [E, Q] and out [R, Q] row-major, dst [E] ascending int32.
// block_e is the least hub size (a power of two), block_r the rows a row
// block (128, 256 or 512); partials (partial_bytes) and counters
// (num_counters, zero) the hub launch's scratch, as
// segment_reduce_hub_scratch() sizes it.  Returns the cudaError_t of the
// launches (0 = success).
#define SEGMENT_ENTRY(NAME, T, ACC)                                          \
  int NAME(const T* contrib, const int* dst, T* out, long long num_edges,   \
           long long num_rows, int q_cols, int combine_code, int block_e,    \
           int block_r, void* partials, long long partial_bytes,             \
           int* counters, long long num_counters, void* stream) {            \
    return launch<T, ACC>(contrib, dst, out, num_edges, num_rows, q_cols,    \
                          combine_code, block_e, block_r, partials,          \
                          partial_bytes, counters, num_counters,             \
                          static_cast<cudaStream_t>(stream));                \
  }
SEGMENT_ENTRY(segment_reduce_f32, float, float)
SEGMENT_ENTRY(segment_reduce_i32, int, long long)
SEGMENT_ENTRY(segment_reduce_i64, long long, long long)
#undef SEGMENT_ENTRY

// out[0] bytes of hub partials and out[1] counters a call over num_edges
// edges and q_cols columns of an integer (wide = 1: 8-byte accumulators)
// or float contribution needs at least hub size block_e; -1 and -1 for an
// illegal block_e.
void segment_reduce_hub_scratch(long long num_edges, int q_cols, int block_e,
                                int wide, long long* out) {
  Blocks b;
  if (!make_blocks(block_e, kDefaultRows, &b)) {
    out[0] = out[1] = -1;
    return;
  }
  hub_scratch_size(num_edges, q_cols, b.hub_min_shift, wide ? 8 : 4, out);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
