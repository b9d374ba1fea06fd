// K19: round-accumulate SpMM, hand-written for Hopper (sm_90a).
//
// Replaces the per-round segment-sum of the overlapped halo exchange,
// `seg` in cleora_tpu/parallel/embed.py:_overlap_propagate (:49-54),
// applied to the shard's own rows at :66 and to each received slab at :72,
// with the residual mix of :192-193 and the row normalisation of
// cleora_tpu/ops/normalize.py (:15, :20) after the last round fused in:
//
//   s[i, :] = sum_{e in [indptr[i], indptr[i+1])} vals[e] * table[cols[e], :]
//   acc[row(i), :] = s[i, :]                      first round (write)
//   acc[row(i), :] += s[i, :]                     later rounds (add)
//   acc[row(i), :] = keep * acc + w * res[row(i)]  last round, when w > 0
//   acc[row(i), :] /= max(||acc[row(i), :]||, 1e-10)  last round, l2 / l1
//
// One call is one round of one shard.  Its view is a CSR over either every
// row of the shard (row(i) = i; the first and the last round, so the first
// writes every row and the last mixes and normalises every row) or a
// compact list of the rows with an edge in the round (row(i) = row_ids[i],
// ascending, each once; the middle rounds).  table is the round's gather
// table: the shard's own state in round 0, the received (M, D) slab after
// it; res is the shard's state.  acc is the float32 (rows_per_shard, D)
// accumulator, updated in place; table and res are both float32 or both
// bfloat16 (the state's dtype, as the slab travels).  With one shard round
// 0 is first and last: one launch is K1 with its epilogue, bit for bit.
//
// Bound on the card: bytes.  A call reads the view (indptr, row_ids),
// cols and vals (8 E B), one table row per distinct column the round
// names, the accumulator rows it adds to (none in the first round) and
// res's rows where w > 0, and writes its rows of acc once; it does 2 E D
// flops, a fraction of a flop per byte.  So the first round writes the
// accumulator (no zero fill to write and read back), and the last leaves
// no separate normalisation pass (a read and a write of the state).
//
// Design: K1's, row_team.cuh's SpMM: a team of lanes a row, float4 slots,
// the row's (col, val) pairs loaded L at a time and broadcast by shuffles,
// a batch of predicated gathers, warp-uniform loop control; the sum stays
// in registers, the old accumulator row is added to it once, and the
// epilogue mixes, normalises and stores the row.  Its gather batch is half
// of K1's (kLoads4), which leaves the registers that rows of 1-2 edges
// need to keep more rows in flight; the adds stay in edge order.  A
// row of more than `long_slice` entries in the round (kernels.LONG_SLICE;
// the decision reads that row's degree in the round alone, so one shard's
// round 0 cuts the rows K1 cuts) is cut into slices, a team each, written
// to the scratch `part` and joined in slice order by spmm_acc_join, which
// then adds the old row and applies the same epilogue.  A row
// appears once per round and the rounds run in order on one stream, so no
// atomics are needed.  D not divisible by 4, or a misaligned table, res or
// acc, takes the one-column slots.

#include <cstdint>

#include <cuda_runtime.h>

#include "row_team.cuh"

// Slot loads in flight a lane with float4 slots: half of K1's.  The
// accumulator row a round adds to, and a middle round's rows of 1-2
// edges, want the registers more than a deep gather batch
// (scripts/torch_k19_k11_probe.py times the rounds against the parent's).
constexpr int kLoads4 = 8;

namespace {

using row_team::kSpmmThreads;

// K19's kernels: row_team's SpMM over a view (row_ids, add), with kLoads4
// float4 slot loads in flight a lane.
template <typename T, bool kVec4, int kS>
__global__ void __launch_bounds__(kSpmmThreads)
    spmm_acc_rows(const int32_t* __restrict__ row_ids,
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
  row_team::spmm_rows<T, kVec4, kS, kVec4 ? kLoads4 : 32, true>(
      row_ids, indptr, indices, vals, x, res, out, n_rows, d, add, keep, w,
      norm, L, long_slice, row_blocks, item_rows, item_starts, item_cuts,
      n_items, part);
}

template <typename T, bool kVec4, int kS>
__global__ void __launch_bounds__(kSpmmThreads)
    spmm_acc_join(const int32_t* __restrict__ row_ids,
                  const int32_t* __restrict__ item_rows,
                  const int32_t* __restrict__ item_cuts,
                  const int32_t* __restrict__ split, int64_t n_split,
                  const float* __restrict__ part, const T* __restrict__ res,
                  float* __restrict__ out, int64_t d, int add, float keep,
                  float w, int norm, int L) {
  row_team::spmm_join<T, kVec4, kS, true>(row_ids, item_rows, item_cuts,
                                         split, n_split, part, res, out, d,
                                         add, keep, w, norm, L);
}

template <typename T, bool kVec4, int kS>
struct Kernels {
  static cudaError_t launch(const row_team::SpmmArgs& a, int L,
                            unsigned tiles) {
    return row_team::spmm_launch_tile<T>(a, L, tiles,
                                         spmm_acc_rows<T, kVec4, kS>,
                                         spmm_acc_join<T, kVec4, kS>);
  }
};

}  // namespace

// Launches K19 on `stream` and returns the first cudaGetLastError() that is
// not 0 (cudaErrorInvalidValue for a normalisation of a row wider than one
// column tile).  A view with no rows (or D = 0) launches nothing: a grid
// of 0 blocks is an invalid configuration.  row_ids null: the view lists
// every row of acc (n_rows of them).  add 0 writes the rows' sums, 1 adds
// them to acc.  keep, w: the residual mix with res (w = 0 reads no res);
// norm: 0 none, 1 l2, 2 l1 (d <= 1024 only).  `vec4` requires d % 4 == 0,
// table and res aligned to 4 elements and acc to 16 bytes (checked by the
// Python wrapper); every row id must lie in [0, rows of acc) and every col
// in [0, rows of table) (checked on the host when the plan is built).
// Rows of more than `long_slice` entries are taken by the n_items slices
// (item_rows, item_starts, item_cuts: kernels.HubPlan of the view; split
// lists the first slice of each of the n_split hub rows), which need
// n_items * d float32 of scratch in `part`; pass long_slice = INT64_MAX and
// no items to walk every row with its own team.
extern "C" int spmm_acc_launch(
    const int32_t* row_ids, const int64_t* indptr, const int32_t* cols,
    const float* vals, const void* table, int table_bf16, const void* res,
    float* acc, int64_t n_rows, int64_t d, int add, float keep, float w,
    int norm, int vec4, int64_t long_slice, const int32_t* item_rows,
    const int64_t* item_starts, const int32_t* item_cuts, int64_t n_items,
    const int32_t* split, int64_t n_split, float* part, void* stream) {
  const row_team::SpmmArgs a{
      row_ids, indptr, cols, vals, table, res, acc, n_rows, d, add, keep, w,
      norm, long_slice, item_rows, item_starts, item_cuts, n_items, split,
      n_split, part, static_cast<cudaStream_t>(stream)};
  return (int)row_team::spmm_launch<Kernels>(a, table_bf16 != 0,
                                             vec4 != 0);
}
