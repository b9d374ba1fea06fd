// One hop of the first-order uniform walk, shared by K8 (walk_uniform.cu:
// every row on one card, from one (indptr, deg) record a row) and K17
// (walk_owned.cu: rows cut into slices, three arrays), so that the two
// cannot drift apart: both draw with philox_x0 and pick.
//
// The hop h (0-based) of the walk whose global index is g, from a row of
// degree d > 0 whose entries start at indptr[row]:
//
//   u    = (x0 >> 8) * 2^-24, x0 the first output word of Philox4x32-10
//          (Salmon et al., SC'11; Random123) at counter
//          (g & 0xffffffff, g >> 32, h, 0) under key (seed lo, seed hi)
//   next = cols[indptr[row] + min(int(u * float(d)), d - 1)]
//
// with one round-to-nearest float32 product and a truncation, which
// ops/walk.py's plain versions repeat, so the walks are bitwise the same on
// the card and on the CPU.  A row is addressed by its index into the tables
// the caller passes: the global node on one card, the row within a slice
// under K17.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace walk_hop {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

// The first output word of Philox4x32-10 at counter (c0, c1, c2, 0).
__device__ __forceinline__ uint32_t philox_x0(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t k0,
                                              uint32_t k1) {
  uint32_t c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c1 = lo1;
    c3 = lo0;
    c0 = n0;
    c2 = n2;
  }
  return c0;
}

// The entry of a row of degree d > 0 that hop's Philox word `bits` picks:
// min(int(u * float(d)), d - 1), u = (bits >> 8) * 2^-24.
__device__ __forceinline__ int32_t pick(uint32_t bits, int32_t d) {
  const float u = __uint2float_rn(bits >> 8) * 5.9604644775390625e-08f;
  const int32_t t = (int32_t)__fmul_rn(u, __int2float_rn(d));
  return t > d - 1 ? d - 1 : t;
}

// The next node of hop h of walk (g0, g1) = (g lo, g hi) from row `row` of
// degree d > 0 (K17's three-array form; K8 reads a row's record and draws
// ahead, walk_uniform.cu).
__device__ __forceinline__ int32_t next(const int32_t* __restrict__ indptr,
                                        const int32_t* __restrict__ cols,
                                        int64_t row, int32_t d, uint32_t g0,
                                        uint32_t g1, uint32_t h, uint32_t k0,
                                        uint32_t k1) {
  const int32_t t = pick(philox_x0(g0, g1, h, k0, k1), d);
  return __ldg(cols + __ldg(indptr + row) + t);
}

}  // namespace walk_hop
