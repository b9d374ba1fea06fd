// K11: the positive-PMI transform of counted pairs, hand-written for Hopper
// (sm_90a).
//
// Replaces the JAX package's PPMI programs, cleora_tpu/ops/cooccur.py
// _colsum_impl (:926-936) and _ppmi_range_impl (:939-965).  A range holds
// one hash partition's unique pairs, sorted by (cen, ctx), with int32 counts;
// every center lives in exactly one range, contexts in all of them.
//
// ppmi_colsum (once per range): col[ctx] += cnt and total += cnt, as exact
//   64-bit integer sums.
// ppmi_rows (once per range, after every range's colsum): for each entry
//   vals = max(logf(max(w * total / (max(rs, 1e-10) * max(cs, 1e-10)),
//                       1e-15)), 0)
//   in float32 and in the JAX program's order, where w = cnt, rs = the row
//   sum of cnt over the entry's center and cs = col[ctx]; the sums are
//   converted to float32 once (round to nearest), so they equal the JAX
//   program's float32 scatter-adds wherever those are exact (below 2^24),
//   and they do not change from run to run.  It also writes the range's CSR
//   row pointer indptr (n + 1 int64): the range's entries in (cen, ctx)
//   order are the CSR of its rows in original row order, with ctx as the
//   column indices and vals as the values.
//
// Bound on the card: bytes.  colsum reads ctx and cnt (8 B per entry) with
// one 8-byte atomic per entry; rows reads cen, ctx and cnt, gathers one
// 8-byte column sum per entry, and writes 4 B per entry plus indptr.
//
// Design: XLA scatters float32 row and column sums over every slot of
// padded buckets.  Here the thread that owns a row's first entry walks the
// row twice, once for its sum and once for the values, so row sums need no
// atomics and no (n,) buffer; the same thread writes the indptr entries
// from the previous center up to its own.  logf is the accurate library
// function (not __logf), and the products and the quotient are
// round-to-nearest, as in the plain version.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void ppmi_colsum_kernel(const int32_t* __restrict__ ctx,
                                   const int32_t* __restrict__ cnt, int64_t m,
                                   unsigned long long* __restrict__ col,
                                   unsigned long long* __restrict__ total) {
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long v = 0ull;
  if (i < m) {
    v = (unsigned long long)(long long)__ldg(cnt + i);
    atomicAdd(col + __ldg(ctx + i), v);
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0ull;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    if (s) atomicAdd(total, s);
  }
}

__global__ void ppmi_rows_kernel(const int32_t* __restrict__ cen,
                                 const int32_t* __restrict__ ctx,
                                 const int32_t* __restrict__ cnt, int64_t m,
                                 int64_t n, const long long* __restrict__ col,
                                 const long long* __restrict__ total,
                                 float* __restrict__ vals,
                                 int64_t* __restrict__ indptr) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int32_t c = __ldg(cen + i);
  const int64_t prev = i == 0 ? -1 : (int64_t)__ldg(cen + i - 1);
  if (prev == c) return;  // not the first entry of its row
  for (int64_t k = prev + 1; k <= c; ++k) indptr[k] = i;
  long long rs = 0;
  int64_t end = i;
  do {
    rs += __ldg(cnt + end);
    ++end;
  } while (end < m && __ldg(cen + end) == c);
  if (end == m)
    for (int64_t k = (int64_t)c + 1; k <= n; ++k) indptr[k] = m;
  const float rsf = fmaxf(__ll2float_rn(rs), 1e-10f);
  const float tot = __ll2float_rn(__ldg(total));
  for (int64_t j = i; j < end; ++j) {
    const float w = (float)__ldg(cnt + j);
    const float cs = fmaxf(__ll2float_rn(__ldg(col + __ldg(ctx + j))), 1e-10f);
    const float q = __fdiv_rn(__fmul_rn(w, tot), __fmul_rn(rsf, cs));
    vals[j] = fmaxf(logf(fmaxf(q, 1e-15f)), 0.f);
  }
}

dim3 grid_for(int64_t len) {
  return dim3((unsigned)((len + kThreads - 1) / kThreads));
}

}  // namespace

// Launches ppmi_colsum on `stream` and returns cudaGetLastError().  `col`
// (n int64) and `total` (1 int64) accumulate across calls.
extern "C" int ppmi_colsum_launch(const int32_t* ctx, const int32_t* cnt,
                                  int64_t m, long long* col, long long* total,
                                  void* stream) {
  if (m > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    ppmi_colsum_kernel<<<grid_for(m), kThreads, 0, s>>>(
        ctx, cnt, m, reinterpret_cast<unsigned long long*>(col),
        reinterpret_cast<unsigned long long*>(total));
  }
  return (int)cudaGetLastError();
}

// Launches ppmi_rows on `stream` and returns cudaGetLastError().  `cen` must
// be non-decreasing with every value below n (checked by the Python wrapper,
// which also zeroes indptr for an empty range).
extern "C" int ppmi_launch(const int32_t* cen, const int32_t* ctx,
                           const int32_t* cnt, int64_t m, int64_t n,
                           const long long* col, const long long* total,
                           float* vals, int64_t* indptr, void* stream) {
  if (m > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    ppmi_rows_kernel<<<grid_for(m), kThreads, 0, s>>>(cen, ctx, cnt, m, n, col,
                                                      total, vals, indptr);
  }
  return (int)cudaGetLastError();
}
