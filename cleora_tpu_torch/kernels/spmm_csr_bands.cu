// K1's band form: CSR SpMM over a band-major panel, hand-written for Hopper
// (sm_90a).
//
// Replaces, at the blocked GraRep's panel, the power step of the JAX
// package's blocked GraRep: cleora_tpu/algorithms.py:640 (spmm_ell on the
// (n, b) transpose of a row block, one call a transition power):
//
//   out[j, r, :] = sum_{e in row r} vals[e] * x[j, indices[e], :]
//
// for every band j.  The panel is band-major: (bands, rows, 32) float32,
// band j holding columns [32 j, 32 j + 32) of every row, one band after the
// other (ops/spmm.py:panel_band chooses it; the padded columns of the last
// band are zero and stay zero).  Over a shard group's all-gather x is the
// (parts, bands, rps, 32) table of every rank's panel, and column c is row
// c % rps of part c / rps: the gather reads it there, so no copy permutes
// the table.
//
// Bound on the card: bytes.  A call reads indptr (8 (N+1) B), indices and
// vals (8 nnz B) and x once (4 N b B), and writes out once (4 N b B); it
// does 2 nnz b flops.  Row-major K1 at GraRep's (200,000, 4,096) panel
// gathers a 16 KB row of a 3.3 GB x from device memory for each entry (its
// floor, 7.8 ms on an H100).
//
// Design.  blockIdx.y is the band, the slow index of the dispatch order, so
// every row takes band j before any row takes band j + 1: a band of x
// (N * 128 B, 25.6 MB at 200,000 rows) stays in the L2 while every row
// gathers from it, and device memory sees x read about once; a band larger
// than the L2 (251 MB at 1.96 M rows) still finds its share of it there,
// where a row-major gather of a row of b columns hardly does.  A team of 8 lanes owns a row's
// band, a float4 each (K1's row team at 32 columns: row_team.cuh's
// gather_sum with 16 edges' gathers in flight), so an entry is one
// coalesced 128-byte load; the sum stays in registers and a warp writes 4
// rows' bands, 512 contiguous bytes of out, with streaming stores so that
// out leaves the L2 before the band of x does.  The CSR is read again for
// each band.  Every element sums its row's entries in K1's edge order with
// K1's arithmetic (the same device function), and a row of more than
// `long_slice` entries is cut into slices and joined in slice order as K1
// cuts it, so the result is K1's on the row-major panel, bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "row_team.cuh"

namespace {

using row_team::kSpmmThreads;

constexpr int kG = 32;      // columns a band: kernels.BAND_COLUMNS
constexpr int kL = kG / 4;  // lanes a row, a float4 each
constexpr int kTeams = kSpmmThreads / kL;
constexpr int kLoads = 16;  // K1's gather depth for float4 slots

__device__ __forceinline__ void store_band(const float (&a)[1][4], float* dst,
                                           int sub) {
  __stcs(reinterpret_cast<float4*>(dst) + sub,
         make_float4(a[0][0], a[0][1], a[0][2], a[0][3]));
}

// Blocks [0, row_blocks) walk the rows, a team each (a row of more than
// long_slice entries is left to its slices); the blocks after them walk
// the n_items slices of the hub rows into `part` ((bands, n_items, 32)).
template <bool kParts>
__global__ void __launch_bounds__(kSpmmThreads)
    spmm_csr_bands_rows(const int64_t* __restrict__ indptr,
                        const int32_t* __restrict__ indices,
                        const float* __restrict__ vals,
                        const float* __restrict__ x, float* __restrict__ out,
                        int64_t n_rows, int64_t rps, int64_t part_stride,
                        int64_t long_slice, int64_t row_blocks,
                        const int32_t* __restrict__ item_rows,
                        const int64_t* __restrict__ item_starts,
                        const int32_t* __restrict__ item_cuts,
                        int64_t n_items, float* __restrict__ part) {
  const int64_t band = blockIdx.y;
  const int sub = threadIdx.x & (kL - 1);
  const bool rows = (int64_t)blockIdx.x < row_blocks;
  const int64_t team =
      ((int64_t)blockIdx.x - (rows ? 0 : row_blocks)) * kTeams +
      threadIdx.x / kL;
  const bool ok[1] = {true};
  float a[1][4] = {{0.f, 0.f, 0.f, 0.f}};
  int64_t e0 = 0, stride = 32, end = 0;
  bool live;
  if (rows) {
    const bool in = team < n_rows;
    e0 = in ? __ldg(indptr + team) : 0;
    end = in ? __ldg(indptr + team + 1) : 0;
    live = in && end - e0 <= long_slice;
  } else {
    live = team < n_items;
    if (live) {
      e0 = __ldg(item_starts + team);
      stride = 32 * (int64_t)__ldg(item_cuts + team);
      end = __ldg(indptr + __ldg(item_rows + team) + 1);
    }
  }
  row_team::gather_sum<float, true, 1, kLoads, false, kParts>(
      a, ok, indices, vals, x + band * rps * kG, kG, 0, kL, sub, live, e0,
      stride, end, rps, part_stride);
  if (!live) return;
  if (rows) {
    store_band(a, out + (band * n_rows + team) * kG, sub);
  } else {
    float* p = part + (band * n_items + team) * kG + 4 * sub;
    *reinterpret_cast<float4*>(p) = make_float4(a[0][0], a[0][1], a[0][2],
                                                a[0][3]);
  }
}

// A team a hub row and band: its slices' sums added in slice order (K1's
// spmm_join), written to the row's band.  split[h] is the first slice of
// hub h.
__global__ void __launch_bounds__(kSpmmThreads)
    spmm_csr_bands_join(const int32_t* __restrict__ item_rows,
                        const int32_t* __restrict__ item_cuts,
                        const int32_t* __restrict__ split, int64_t n_split,
                        const float* __restrict__ part,
                        float* __restrict__ out, int64_t n_rows,
                        int64_t n_items) {
  const int64_t band = blockIdx.y;
  const int sub = threadIdx.x & (kL - 1);
  const int64_t h = (int64_t)blockIdx.x * kTeams + threadIdx.x / kL;
  if (h >= n_split) return;
  const int64_t w0 = __ldg(split + h);
  const int cuts = __ldg(item_cuts + w0);
  const int64_t row = __ldg(item_rows + w0);
  float a[1][4] = {{0.f, 0.f, 0.f, 0.f}};
  const float* p = part + (band * n_items + w0) * kG + 4 * sub;
  for (int j = 0; j < cuts; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(p + (int64_t)j * kG);
    a[0][0] += v.x;
    a[0][1] += v.y;
    a[0][2] += v.z;
    a[0][3] += v.w;
  }
  store_band(a, out + (band * n_rows + row) * kG, sub);
}

}  // namespace

// Launches K1's band form on `stream` and returns the first
// cudaGetLastError() that is not 0.  x is the (parts, bands, rps, 32)
// float32 table (parts = 1: one card's (bands, rps, 32) panel), aligned to
// 16 bytes, with every column index below parts * rps; out is (bands,
// n_rows, 32).  Rows of more than `long_slice` entries are taken by the
// n_items slices (kernels.HubPlan; split lists the first slice of each of
// the n_split hub rows), which need bands * n_items * 32 float32 of scratch
// in `part`; pass long_slice = INT64_MAX and no items to walk every row
// with its own team.
extern "C" int spmm_csr_bands_launch(
    const int64_t* indptr, const int32_t* indices, const float* vals,
    const float* x, float* out, int64_t n_rows, int64_t rps, int64_t parts,
    int64_t bands, int64_t long_slice, const int32_t* item_rows,
    const int64_t* item_starts, const int32_t* item_cuts, int64_t n_items,
    const int32_t* split, int64_t n_split, float* part, void* stream) {
  if (n_rows <= 0 || bands <= 0) return (int)cudaGetLastError();
  if (bands > 65535 || parts < 1 || rps < 1 || rps > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t row_blocks = (n_rows + kTeams - 1) / kTeams;
  const int64_t item_blocks = (n_items + kTeams - 1) / kTeams;
  const dim3 grid((unsigned)(row_blocks + item_blocks), (unsigned)bands);
  const int64_t part_stride = bands * rps * kG;
  if (parts > 1) {
    spmm_csr_bands_rows<true><<<grid, kSpmmThreads, 0, s>>>(
        indptr, indices, vals, x, out, n_rows, rps, part_stride, long_slice,
        row_blocks, item_rows, item_starts, item_cuts, n_items, part);
  } else {
    spmm_csr_bands_rows<false><<<grid, kSpmmThreads, 0, s>>>(
        indptr, indices, vals, x, out, n_rows, rps, part_stride, long_slice,
        row_blocks, item_rows, item_starts, item_cuts, n_items, part);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_split > 0) {
    const dim3 jgrid((unsigned)((n_split + kTeams - 1) / kTeams),
                     (unsigned)bands);
    spmm_csr_bands_join<<<jgrid, kSpmmThreads, 0, s>>>(
        item_rows, item_cuts, split, n_split, part, out, n_rows, n_items);
  }
  return (int)cudaGetLastError();
}
