// K14: one label-propagation step, hand-written for Hopper (sm_90a).
//
// Replaces the loop body of the JAX package's _label_prop_jit
// (cleora_tpu/classify.py:88-105), an SpMM over S = D^-1 A
// (cleora_tpu/ops/spmm.py spmm_inner, :249) with its tail and clamp:
//
//   s         = sum_{e in row i} vals[e] * f[indices[e], :]
//   out[i, :] = mask[i] ? y[i, :] : alpha * s + beta * y[i, :]
//
// with f, y and out float32 (n, C) and beta = 1 - alpha rounded to float32
// by the caller.  C is the class count: 2 to 50, seldom a multiple of 4
// (classify.py carries its buffers at a stride rounded up to 4, so the
// main path's rows are float4 groups).
//
// Bound on the card: bytes.  A step reads the CSR (8 (n+1) + 8 nnz B), f and
// y (4 n C B each) and the mask (n B), and writes out (4 n C B); it does
// 2 nnz C + 3 n C flops.  Each entry gathers a row of f, so on a graph whose
// f exceeds the 50 MB L2 that gather (nnz rows of 4 C B, in 32-byte
// sectors) is the floor.
//
// Design: row_team.cuh's layout and gather-sum, as K1's.  A team of L
// lanes owns a row (the smallest power of two that gives each lane a
// column group, a warp from 32 groups on; 32 / L rows a warp); a group is 4
// columns (a float4) when C % 4 == 0 and the rows are 16-byte aligned, else
// one column.  The team loads its row's next L (col, val) pairs in one
// coalesced load, broadcasts them by shuffle and issues the gathers of a
// batch of edges together before it adds them in edge order; the mask and
// the row's bounds are loaded together, y's row before or after the
// gathers (kVecEarlyY, kScalarEarlyY).  The epilogue is the tail and the
// clamp: a clamped row reads no edge and copies y.
// Every product and sum is a round-to-nearest intrinsic (gather_sum's
// kRound: no fused multiply-add) in edge order, so the output is bitwise
// the plain version run on the CPU (index_add_ in edge order) and the
// design before this one (a warp a row, one column a lane).  A row of any
// length is walked by its own team: hub slices would add a row's pieces in
// another order.  out must not alias f (other rows gather it).

#include <cstdint>

#include <cuda_runtime.h>

#include "row_team.cuh"

namespace {

using row_team::Cols;
constexpr int kThreads = 256;
// slot loads in flight a lane (row_team's kLoads): rows hold 6-7 entries
// on the main path's graph; a batch of 8 gathers covers a row and leaves
// registers for more warps (at C = 40 a batch of 4 was 16 % slower and
// K1's 16 12 %; with single columns at C = 47 a batch of 16 was 10 %
// slower; H100, scripts/torch_k14_sweep.py)
constexpr int kVecLoads = 8;
constexpr int kScalarLoads = 8;
// where y's row is loaded: before the gathers its latency hides behind
// theirs, but it holds registers through them.  With float4 groups after
// the gathers is the faster (before: 12 % slower at C = 40), with single
// columns before them (after: 12 % slower at C = 47; the same sweep)
constexpr bool kVecEarlyY = false;
constexpr bool kScalarEarlyY = true;

template <bool kVec4, int kS>
__global__ void __launch_bounds__(kThreads)
    label_prop_rows(const int64_t* __restrict__ indptr,
                    const int32_t* __restrict__ indices,
                    const float* __restrict__ vals,
                    const float* __restrict__ f, const float* __restrict__ y,
                    const uint8_t* __restrict__ mask, float* __restrict__ out,
                    int64_t n_rows, int64_t c, float alpha, float beta,
                    int L) {
  constexpr int kP = Cols<kVec4>::kP;
  const int sub = threadIdx.x & (L - 1);
  const int64_t row =
      (int64_t)blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const int64_t c0 = (int64_t)blockIdx.y * L * kS * kP;
  bool ok[kS];
  row_team::slots_ok<kVec4, kS>(ok, c0, c, L, sub);
  float a[kS][kP], r[kS][kP];
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q) a[t][q] = r[t][q] = 0.f;
  const bool in = row < n_rows;
  const float* yr = y + (in ? row : 0) * c + c0;
  const auto load_y = [&] {
#pragma unroll
    for (int t = 0; t < kS; ++t)
      if (in && ok[t])
        row_team::load_slot(r[t], yr + (int64_t)(sub + L * t) * kP);
  };
  // the mask and the row's bounds are loaded together
  const bool clamp = in && __ldg(mask + row) != 0;
  const int64_t start = in ? __ldg(indptr + row) : 0;
  const int64_t end = in ? __ldg(indptr + row + 1) : 0;
  constexpr bool kEarlyY = kVec4 ? kVecEarlyY : kScalarEarlyY;
  if constexpr (kEarlyY) load_y();
  row_team::gather_sum<float, kVec4, kS, kVec4 ? kVecLoads : kScalarLoads,
                       true>(a, ok, indices, vals, f, c, c0, L, sub,
                             in && !clamp, start, 32, end);
  if (!in) return;
  if constexpr (!kEarlyY) load_y();
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q)
      a[t][q] = clamp ? r[t][q]
                      : __fadd_rn(__fmul_rn(a[t][q], alpha),
                                  __fmul_rn(r[t][q], beta));
  row_team::store_team<kS, kP>(a, ok, out + row * c + c0, L, sub);
}

template <bool kVec4, int kS>
cudaError_t launch(const int64_t* indptr, const int32_t* indices,
                   const float* vals, const float* f, const float* y,
                   const uint8_t* mask, float* out, int64_t n_rows,
                   int64_t c, float alpha, float beta,
                   const row_team::Layout& lay, cudaStream_t stream) {
  const int64_t teams = kThreads / lay.L;
  const dim3 grid((unsigned)((n_rows + teams - 1) / teams), lay.tiles);
  label_prop_rows<kVec4, kS><<<grid, kThreads, 0, stream>>>(
      indptr, indices, vals, f, y, mask, out, n_rows, c, alpha, beta, lay.L);
  return cudaGetLastError();
}

template <bool kVec4>
cudaError_t launch_slots(const int64_t* indptr, const int32_t* indices,
                         const float* vals, const float* f, const float* y,
                         const uint8_t* mask, float* out, int64_t n_rows,
                         int64_t c, float alpha, float beta,
                         const row_team::Layout& lay, cudaStream_t s) {
  switch (lay.slots) {
    case 1: return launch<kVec4, 1>(indptr, indices, vals, f, y, mask, out,
                                    n_rows, c, alpha, beta, lay, s);
    case 2: return launch<kVec4, 2>(indptr, indices, vals, f, y, mask, out,
                                    n_rows, c, alpha, beta, lay, s);
    case 4: return launch<kVec4, 4>(indptr, indices, vals, f, y, mask, out,
                                    n_rows, c, alpha, beta, lay, s);
    case 8: return launch<kVec4, 8>(indptr, indices, vals, f, y, mask, out,
                                    n_rows, c, alpha, beta, lay, s);
  }
  if constexpr (!kVec4) {
    if (lay.slots == 16)
      return launch<kVec4, 16>(indptr, indices, vals, f, y, mask, out, n_rows,
                               c, alpha, beta, lay, s);
    if (lay.slots == 32)
      return launch<kVec4, 32>(indptr, indices, vals, f, y, mask, out, n_rows,
                               c, alpha, beta, lay, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches K14 on `stream` and returns cudaGetLastError().  `mask` holds one
// byte per row (a torch.bool tensor), nonzero for a clamped row.  `vec4`
// requires c % 4 == 0 and f, y and out aligned to 16 bytes (checked by the
// Python wrapper).
extern "C" int label_prop_launch(const int64_t* indptr, const int32_t* indices,
                                 const float* vals, const float* f,
                                 const float* y, const uint8_t* mask,
                                 float* out, int64_t n_rows, int64_t c,
                                 float alpha, float beta, int vec4,
                                 void* stream) {
  if (n_rows <= 0 || c <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const row_team::Layout lay = row_team::layout(c, vec4 != 0);
  return (int)(vec4 ? launch_slots<true>(indptr, indices, vals, f, y, mask,
                                         out, n_rows, c, alpha, beta, lay, s)
                    : launch_slots<false>(indptr, indices, vals, f, y, mask,
                                          out, n_rows, c, alpha, beta, lay,
                                          s));
}
