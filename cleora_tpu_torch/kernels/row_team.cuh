// The row team shared by K1 (spmm_csr.cu), K2's kernel for rows of up to
// 1,024 columns (row_normalize.cu) and the fused attention pass
// (edge_attention.cu): its layout and its epilogue, the row normalisation.
//
// Layout.  A team of L lanes owns a row: a whole warp from 32 column
// groups on, else the smallest power of two that gives each lane a group,
// so a warp serves 32 / L rows.  A group is 4 columns (a float4) when
// D % 4 == 0, else 1 column.  Each lane holds S slots, slot t of lane sub
// at group sub + L t; a tile of L S groups is at most 1,024 columns (8
// float4 slots or 32 single columns a lane).
//
// Epilogue.  The row's sum of squares (l2) or of absolute values (l1) with
// explicit roundings in slot order, one butterfly of shuffles over the
// team, and an IEEE division by max(norm, 1e-10).  K1 and K2 both call
// normalize_team, so K2 after K1 (or after K19's round sums, halo="overlap")
// gives K1 with the normalisation fused, bit for bit.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace row_team {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxColumns = 1024;  // one tile: kernels.FUSED_NORM_MAX_WIDTH

inline int pow2_at_least(int64_t v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

struct Layout {
  int L;           // lanes a row
  int slots;       // slots a lane in a tile
  unsigned tiles;  // column tiles of a row (1 up to kMaxColumns)
};

// The layout of rows of d columns; vec4: groups of 4 columns.
inline Layout layout(int64_t d, bool vec4) {
  const int64_t groups = vec4 ? d / 4 : d;
  const int max_slots = vec4 ? kMaxColumns / 4 / 32 : kMaxColumns / 32;
  const int L = groups >= 32 ? 32 : pow2_at_least(groups);
  const int64_t need = (groups + L - 1) / L;
  const int slots = pow2_at_least(need < max_slots ? need : max_slots);
  const int64_t tile = (int64_t)L * slots;
  return {L, slots, (unsigned)((groups + tile - 1) / tile)};
}

// Divides the team's row a (slots of kP columns) by max(its norm, 1e-10):
// norm 1 l2, 2 l1, 0 leaves it.  Slots past the row hold 0.  Every lane of
// the warp calls this (the butterfly runs with the full mask).
template <int kS, int kP>
__device__ __forceinline__ void normalize_team(float (&a)[kS][kP], int norm,
                                               int L) {
  if (norm == 0) return;
  float s = 0.f;
  if (norm == 1) {
#pragma unroll
    for (int t = 0; t < kS; ++t)
#pragma unroll
      for (int q = 0; q < kP; ++q) s = __fmaf_rn(a[t][q], a[t][q], s);
  } else {
#pragma unroll
    for (int t = 0; t < kS; ++t)
#pragma unroll
      for (int q = 0; q < kP; ++q) s = __fadd_rn(s, fabsf(a[t][q]));
  }
  for (int off = L >> 1; off > 0; off >>= 1)
    s += __shfl_xor_sync(kAll, s, off, L);
  const float denom = fmaxf(norm == 1 ? sqrtf(s) : s, 1e-10f);
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q) a[t][q] /= denom;
}

// Stores the team's slots of a at row (the row's first column of the
// tile); ok[t]: slot t lies in the row.
template <int kS, int kP>
__device__ __forceinline__ void store_team(const float (&a)[kS][kP],
                                           const bool (&ok)[kS], float* row,
                                           int L, int sub) {
#pragma unroll
  for (int t = 0; t < kS; ++t) {
    if (!ok[t]) continue;
    float* o = row + (int64_t)(sub + L * t) * kP;
    if constexpr (kP == 4) {
      *reinterpret_cast<float4*>(o) =
          make_float4(a[t][0], a[t][1], a[t][2], a[t][3]);
    } else {
      o[0] = a[t][0];
    }
  }
}

}  // namespace row_team
