// K1: CSR SpMM propagate with the row normalisation in its epilogue,
// hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's propagate programs: cleora_tpu/ops/spmm_ell.py
// spmm_ell (:437) with its bucket body _bucket_out (:421), and
// cleora_tpu/ops/spmm.py spmm_inner (:249, flat path :319-324).  The
// residual mix of cleora_tpu/ops/loop.py:65-66 and the row normalisation of
// cleora_tpu/ops/normalize.py l2_normalize (:15) / l1_normalize (:20) are
// fused into the epilogue:
//
//   out[r, :] = sum_{e in row r} vals[e] * x[indices[e], :]
//   out[r, :] = keep * out[r, :] + w * res[r, :]          when w > 0
//   out[r, :] /= max(||out[r, :]||, 1e-10)                 norm 1 (l2), 2 (l1)
//
// res is x itself on one device.  In the sharded loop (parallel/embed.py)
// x is the gather table (the all-gathered state or the received halo slab,
// which may have fewer rows than the shard) and res the shard's own state,
// as in cleora_tpu/parallel/embed.py:192-193.  x and res are both float32
// or both bfloat16; the sum is always float32 and out is float32.
//
// Bound on the card: bytes.  A call reads indptr (8 (N+1) B), indices and
// vals (8 nnz B) and one row of x per edge (nnz * D * sizeof(x) B), and
// writes out (4 N D B); it does 2 nnz D flops, about a quarter of a flop per
// byte, far below the card's balance point.  On a random graph whose x
// exceeds the 50 MB L2 every gathered row comes from device memory, so
// that gather (one x row per edge) is the floor the design aims at.
//
// Design: row_team.cuh's SpMM, whose bodies K19 runs too.  A team of L lanes
// (a whole warp from D = 128 on; for narrower rows the smallest power of
// two that gives each lane a column group, so a warp serves 32 / L rows)
// owns an output row.  Each lane holds S slots of 4 columns (one float4, or
// 4 bf16 in 8 bytes) or, when D % 4 != 0, of one column; D <= 1024 is one
// column tile, a wider row is cut into tiles of 1024 columns (grid.y),
// which cannot normalise and leave that to K2.  The team loads its row's
// next L (col, val) pairs in one coalesced load, broadcasts them with
// __shfl_sync, and issues the gathers of a batch of 16 / S edges together,
// predicated, before it adds them in edge order, so a short row (6-7
// entries on the phase-5 graph) waits on one round of memory latency.  The
// sum stays in registers; the epilogue mixes the residual, takes the row's
// sum of squares (or of absolute values) with one butterfly of shuffles
// over the team, divides and writes the row once, so the separate K2 pass
// over the state (a read and a write of it) is gone.
//
// Hub rows.  A row of more than `long_slice` entries (kernels.LONG_SLICE =
// 4,096: the decision reads that row's degree alone, so a shard of a graph
// decides as the whole graph does) is not walked by its row team but cut
// into K = ceil(entries / long_slice) slices, a team each, launched in the
// same grid after the rows: slice j takes the row's chunks of 32 entries
// j, j + K, j + 2K, ... (K5's spmm_axpy_slices) and writes its sum to the
// scratch `part`.  spmm_csr_join then adds a hub's slices in slice order
// (deterministic: no float atomics) and applies the same epilogue.

#include <cstdint>

#include <cuda_runtime.h>

#include "row_team.cuh"

namespace {

using row_team::kSpmmThreads;

// K1's kernels: row_team's SpMM over every row, writing, with 16 float4
// slot loads in flight a lane.
template <typename T, bool kVec4, int kS>
__global__ void __launch_bounds__(kSpmmThreads)
    spmm_csr_rows(const int32_t* __restrict__ row_ids,
                  const int64_t* __restrict__ indptr,
                  const int32_t* __restrict__ indices,
                  const float* __restrict__ vals, const T* __restrict__ x,
                  const T* __restrict__ res, float* __restrict__ out,
                  int64_t n_rows, int64_t d, int add, float keep, float w,
                  int norm, int L, int64_t long_slice, int64_t row_blocks,
                  const int32_t* __restrict__ item_rows,
                  const int64_t* __restrict__ item_starts,
                  const int32_t* __restrict__ item_cuts, int64_t n_items,
                  float* __restrict__ part) {
  row_team::spmm_rows<T, kVec4, kS, kVec4 ? 16 : 32, false>(
      row_ids, indptr, indices, vals, x, res, out, n_rows, d, add, keep, w,
      norm, L, long_slice, row_blocks, item_rows, item_starts, item_cuts,
      n_items, part);
}

template <typename T, bool kVec4, int kS>
__global__ void __launch_bounds__(kSpmmThreads)
    spmm_csr_join(const int32_t* __restrict__ row_ids,
                  const int32_t* __restrict__ item_rows,
                  const int32_t* __restrict__ item_cuts,
                  const int32_t* __restrict__ split, int64_t n_split,
                  const float* __restrict__ part, const T* __restrict__ res,
                  float* __restrict__ out, int64_t d, int add, float keep,
                  float w, int norm, int L) {
  row_team::spmm_join<T, kVec4, kS, false>(row_ids, item_rows, item_cuts,
                                          split, n_split, part, res, out, d,
                                          add, keep, w, norm, L);
}

template <typename T, bool kVec4, int kS>
struct Kernels {
  static cudaError_t launch(const row_team::SpmmArgs& a, int L,
                            unsigned tiles) {
    return row_team::spmm_launch_tile<T>(a, L, tiles,
                                         spmm_csr_rows<T, kVec4, kS>,
                                         spmm_csr_join<T, kVec4, kS>);
  }
};

}  // namespace

// Launches K1 on `stream` and returns the first cudaGetLastError() that is
// not 0 (cudaErrorInvalidValue for a normalisation of a row wider than one
// column tile).  `vec4` requires d % 4 == 0 and x and res aligned to 4
// elements (checked by the Python wrapper).  norm: 0 none, 1 l2, 2 l1 (d
// <= 1024 only).  Rows of more than `long_slice` entries are taken by the
// n_items slices (item_rows, item_starts, item_cuts: kernels.HubPlan; split
// lists the first slice of each of the n_split hub rows), which need
// n_items * d float32 of scratch in `part`; pass long_slice = INT64_MAX
// and no items to walk every row with its own team.
extern "C" int spmm_csr_launch(
    const int64_t* indptr, const int32_t* indices, const float* vals,
    const void* x, int x_bf16, const void* res, float* out, int64_t n_rows,
    int64_t d, float keep, float w, int norm, int vec4, int64_t long_slice,
    const int32_t* item_rows, const int64_t* item_starts,
    const int32_t* item_cuts, int64_t n_items, const int32_t* split,
    int64_t n_split, float* part, void* stream) {
  const row_team::SpmmArgs a{
      nullptr, indptr, indices, vals, x, res, out, n_rows, d, 0, keep, w,
      norm, long_slice, item_rows, item_starts, item_cuts, n_items, split,
      n_split, part, static_cast<cudaStream_t>(stream)};
  return (int)row_team::spmm_launch<Kernels>(a, x_bf16 != 0, vec4 != 0);
}
