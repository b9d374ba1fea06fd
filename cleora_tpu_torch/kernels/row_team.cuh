// The row team shared by K1 (spmm_csr.cu), K19 (spmm_acc.cu), K2's kernel
// for rows of up to 1,024 columns (row_normalize.cu) and the fused
// attention pass (edge_attention.cu): its layout, the row-team SpMM that
// K1 and K19 launch, and its epilogue, the residual mix and the row
// normalisation.
//
// Layout.  A team of L lanes owns a row: a whole warp from 32 column
// groups on, else the smallest power of two that gives each lane a group,
// so a warp serves 32 / L rows.  A group is 4 columns (a float4) when
// D % 4 == 0, else 1 column.  Each lane holds S slots, slot t of lane sub
// at group sub + L t; a tile of L S groups is at most 1,024 columns (8
// float4 slots or 32 single columns a lane).
//
// Gather-sum.  The team loads its row's next L (col, val) pairs in one
// coalesced load, broadcasts them with __shfl_sync and issues the gathers
// of a batch of edges together, predicated, before it adds them in edge
// order; loop control is warp-uniform, so the shuffles run with the full
// mask even when a warp holds several teams.
//
// Epilogue.  The residual mix, then the row's sum of squares (l2) or of
// absolute values (l1) with explicit roundings in slot order, one
// butterfly of shuffles over the team, and an IEEE division by
// max(norm, 1e-10).  K1, K19 and K2 all call normalize_team, so K19's last
// round, or K2 after K1, gives K1 with the normalisation fused, bit for
// bit.
//
// The SpMM (spmm_launch).  Rows of at most long_slice entries are walked
// by their team; a longer (hub) row is cut into K = ceil(entries /
// long_slice) slices, a team each, launched in the same grid after the
// rows: slice j takes the row's chunks of 32 entries j, j + K, j + 2K, ...
// and writes its sum to the scratch `part`, and spmm_join adds a hub's
// slices in slice order (no float atomics) and applies the epilogue.  A
// view may list a subset of the output rows (row_ids) and add its sums to
// the rows' old values (add) where it is built with kView (K19); K1 builds
// it without, so its code has neither branch (they cost K1 4 % at full
// width).  The gather depth (kLoads) does not change the order of the
// adds, so K19 over every row, writing, is K1 bit for bit.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
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

// Columns a slot.
template <bool kVec4>
struct Cols {
  static constexpr int kP = kVec4 ? 4 : 1;
};

__device__ __forceinline__ void load_slot(float (&o)[4], const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load_slot(float (&o)[4],
                                          const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ void load_slot(float (&o)[1], const float* p) {
  o[0] = __ldg(p);
}

__device__ __forceinline__ void load_slot(float (&o)[1],
                                          const __nv_bfloat16* p) {
  o[0] = __bfloat162float(*p);
}

// Adds vals[e] * x[indices[e], tile] over the team's entries to acc, in
// entry order: entries e0 + n * stride + [0, 32) (chunks of 32) up to
// `end`, walked L at a time, with kLoads / kS edges' gathers in flight (at
// least 2; the order of the adds does not depend on it).  A row is stride
// 32 (every chunk); slice j of K is e0 = row start + 32 j, stride 32 K.
// Every lane of the warp calls this, `live` or not.
template <typename T, bool kVec4, int kS, int kLoads>
__device__ __forceinline__ void gather_sum(
    float (&acc)[kS][Cols<kVec4>::kP], const bool (&ok)[kS],
    const int32_t* __restrict__ indices, const float* __restrict__ vals,
    const T* __restrict__ x, int64_t d, int64_t c0, int L, int sub, bool live,
    int64_t e0, int64_t stride, int64_t end) {
  constexpr int kP = Cols<kVec4>::kP;
  constexpr int kB = kLoads / kS > 2 ? kLoads / kS : 2;  // edges in flight
  const int per = 32 / L;  // segments of L entries in a chunk of 32
  for (int64_t i = 0;; ++i) {
    const int64_t b = e0 + (i / per) * stride + (i % per) * L;
    const bool more = live && b < end;
    if (!__any_sync(kAll, more)) break;
    const int k = more ? (int)(end - b < L ? end - b : L) : 0;
    int col = 0;
    float v = 0.f;
    if (sub < k) {
      col = __ldg(indices + b + sub);
      v = __ldg(vals + b + sub);
    }
    const int kmax = (int)__reduce_max_sync(kAll, (unsigned)k);
    for (int j = 0; j < kmax; j += kB) {
      float g[kB][kS][kP];
      float vj[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int cj = __shfl_sync(kAll, col, j + u, L);
        vj[u] = __shfl_sync(kAll, v, j + u, L);
        const T* xr = x + (int64_t)cj * d + c0;
#pragma unroll
        for (int t = 0; t < kS; ++t) {
          if (j + u < k && ok[t]) {
            load_slot(g[u][t], xr + (int64_t)(sub + L * t) * kP);
          } else {
#pragma unroll
            for (int q = 0; q < kP; ++q) g[u][t][q] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (j + u < k) {
#pragma unroll
          for (int t = 0; t < kS; ++t)
#pragma unroll
            for (int q = 0; q < kP; ++q) acc[t][q] += vj[u] * g[u][t][q];
        }
      }
    }
  }
}

// The epilogue of a row: the residual mix, the row normalisation (one
// butterfly over the team; every lane of the warp calls this) and the
// store of the team's columns of out.
template <typename T, bool kVec4, int kS>
__device__ __forceinline__ void finish(float (&acc)[kS][Cols<kVec4>::kP],
                                       const bool (&ok)[kS], const T* res_row,
                                       float* out_row, float keep, float w,
                                       int norm, int L, int sub, bool live) {
  constexpr int kP = Cols<kVec4>::kP;
  if (live && w > 0.f) {
#pragma unroll
    for (int t = 0; t < kS; ++t) {
      if (!ok[t]) continue;
      float r[kP];
      load_slot(r, res_row + (int64_t)(sub + L * t) * kP);
#pragma unroll
      for (int q = 0; q < kP; ++q) acc[t][q] = keep * acc[t][q] + w * r[q];
    }
  }
  normalize_team<kS, kP>(acc, norm, L);
  if (live) store_team<kS, kP>(acc, ok, out_row, L, sub);
}

template <bool kVec4, int kS>
__device__ __forceinline__ void slots_ok(bool (&ok)[kS], int64_t c0,
                                         int64_t d, int L, int sub) {
#pragma unroll
  for (int t = 0; t < kS; ++t)
    ok[t] = c0 + (int64_t)(sub + L * t) * Cols<kVec4>::kP < d;
}

constexpr int kSpmmThreads = 256;

template <bool kView>
__device__ __forceinline__ int64_t out_row(const int32_t* row_ids,
                                           int64_t i) {
  if constexpr (kView) return row_ids ? (int64_t)__ldg(row_ids + i) : i;
  return i;
}

// a = old + a for the team's columns of an output row: the view's sum
// added to the row's old value once, in the plain version's order.
template <bool kVec4, int kS>
__device__ __forceinline__ void add_old(float (&a)[kS][Cols<kVec4>::kP],
                                        const bool (&ok)[kS],
                                        const float* old_row, int L,
                                        int sub) {
  constexpr int kP = Cols<kVec4>::kP;
#pragma unroll
  for (int t = 0; t < kS; ++t) {
    if (!ok[t]) continue;
    const float* p = old_row + (int64_t)(sub + L * t) * kP;
    if constexpr (kP == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      a[t][0] = __fadd_rn(v.x, a[t][0]);
      a[t][1] = __fadd_rn(v.y, a[t][1]);
      a[t][2] = __fadd_rn(v.z, a[t][2]);
      a[t][3] = __fadd_rn(v.w, a[t][3]);
    } else {
      a[t][0] = __fadd_rn(p[0], a[t][0]);
    }
  }
}

// The body of a rows kernel: blocks [0, row_blocks) walk the view's rows,
// a team each (a row of more than long_slice entries is left to its
// slices); the blocks after them walk the n_items slices of the hub rows
// into `part`.  Each library wraps it in a __global__ of its own name
// (spmm_csr_rows, spmm_acc_rows), so a trace tells K1 and K19 apart.
template <typename T, bool kVec4, int kS, int kLoads, bool kView>
__device__ __forceinline__ void spmm_rows(
    const int32_t* __restrict__ row_ids, const int64_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const float* __restrict__ vals,
    const T* __restrict__ x, const T* __restrict__ res,
    float* __restrict__ out, int64_t n_rows, int64_t d, int add, float keep,
    float w, int norm, int L, int64_t long_slice, int64_t row_blocks,
    const int32_t* __restrict__ item_rows,
    const int64_t* __restrict__ item_starts,
    const int32_t* __restrict__ item_cuts, int64_t n_items,
    float* __restrict__ part) {
  constexpr int kP = Cols<kVec4>::kP;
  const int sub = threadIdx.x & (L - 1);
  const bool rows = (int64_t)blockIdx.x < row_blocks;
  const int64_t team =
      ((int64_t)blockIdx.x - (rows ? 0 : row_blocks)) * (kSpmmThreads / L) +
      threadIdx.x / L;
  const int64_t c0 = (int64_t)blockIdx.y * L * kS * kP;
  bool ok[kS];
  slots_ok<kVec4, kS>(ok, c0, d, L, sub);
  float a[kS][kP];
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q) a[t][q] = 0.f;
  if (rows) {
    const bool in = team < n_rows;
    const int64_t start = in ? __ldg(indptr + team) : 0;
    const int64_t end = in ? __ldg(indptr + team + 1) : 0;
    const bool live = in && end - start <= long_slice;
    gather_sum<T, kVec4, kS, kLoads>(a, ok, indices, vals, x, d, c0, L, sub,
                                     live, start, 32, end);
    const int64_t row = live ? out_row<kView>(row_ids, team) : 0;
    float* dst = out + row * d + c0;
    if (kView && live && add) add_old<kVec4, kS>(a, ok, dst, L, sub);
    finish<T, kVec4, kS>(a, ok, res + row * d + c0, dst, keep, w, norm, L,
                         sub, live);
  } else {
    const bool live = team < n_items;
    int64_t e0 = 0, stride = 32, end = 0;
    if (live) {
      e0 = __ldg(item_starts + team);
      stride = 32 * (int64_t)__ldg(item_cuts + team);
      end = __ldg(indptr + __ldg(item_rows + team) + 1);
    }
    gather_sum<T, kVec4, kS, kLoads>(a, ok, indices, vals, x, d, c0, L, sub,
                                     live, e0, stride, end);
    if (!live) return;
#pragma unroll
    for (int t = 0; t < kS; ++t) {
      if (!ok[t]) continue;
      float* p = part + team * d + c0 + (int64_t)(sub + L * t) * kP;
#pragma unroll
      for (int q = 0; q < kP; ++q) p[q] = a[t][q];
    }
  }
}

// The body of a join kernel: a team a hub row, its slices' sums added in
// slice order, then the old row and the epilogue.  split[h] is the first
// slice of hub h.
template <typename T, bool kVec4, int kS, bool kView>
__device__ __forceinline__ void spmm_join(
    const int32_t* __restrict__ row_ids,
    const int32_t* __restrict__ item_rows,
    const int32_t* __restrict__ item_cuts, const int32_t* __restrict__ split,
    int64_t n_split, const float* __restrict__ part,
    const T* __restrict__ res, float* __restrict__ out, int64_t d, int add,
    float keep, float w, int norm, int L) {
  constexpr int kP = Cols<kVec4>::kP;
  const int sub = threadIdx.x & (L - 1);
  const int64_t h = (int64_t)blockIdx.x * (kSpmmThreads / L) + threadIdx.x / L;
  const int64_t c0 = (int64_t)blockIdx.y * L * kS * kP;
  const bool live = h < n_split;
  bool ok[kS];
  slots_ok<kVec4, kS>(ok, c0, d, L, sub);
  float a[kS][kP];
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q) a[t][q] = 0.f;
  int64_t row = 0;
  if (live) {
    const int64_t w0 = __ldg(split + h);
    const int cuts = __ldg(item_cuts + w0);
    row = out_row<kView>(row_ids, __ldg(item_rows + w0));
    for (int j = 0; j < cuts; ++j) {
      const float* p = part + (w0 + j) * d + c0;
#pragma unroll
      for (int t = 0; t < kS; ++t) {
        if (!ok[t]) continue;
#pragma unroll
        for (int q = 0; q < kP; ++q)
          a[t][q] += p[(int64_t)(sub + L * t) * kP + q];
      }
    }
  }
  float* dst = out + row * d + c0;
  if (kView && live && add) add_old<kVec4, kS>(a, ok, dst, L, sub);
  finish<T, kVec4, kS>(a, ok, res + row * d + c0, dst, keep, w, norm, L, sub,
                       live);
}

// The arguments of one SpMM launch (spmm_launch).
struct SpmmArgs {
  const int32_t* row_ids;  // null: the view lists every row of out (kView)
  const int64_t* indptr;
  const int32_t* indices;
  const float* vals;
  const void* x;    // the gather table, float32 or bfloat16
  const void* res;  // the residual rows, of x's dtype
  float* out;
  int64_t n_rows, d;
  int add;  // 1: add the view's sums to out's rows (kView)
  float keep, w;
  int norm;
  int64_t long_slice;
  const int32_t* item_rows;
  const int64_t* item_starts;
  const int32_t* item_cuts;
  int64_t n_items;
  const int32_t* split;
  int64_t n_split;
  float* part;
  cudaStream_t stream;
};

// Launches a library's rows kernel and, where there are hub rows, its join
// kernel (both with the bodies above) for one tile layout.
template <typename T, typename Rows, typename Join>
cudaError_t spmm_launch_tile(const SpmmArgs& a, int L, unsigned tiles,
                             Rows rows, Join join) {
  const int64_t teams = kSpmmThreads / L;
  const int64_t row_blocks = (a.n_rows + teams - 1) / teams;
  const int64_t item_blocks = (a.n_items + teams - 1) / teams;
  const T* x = static_cast<const T*>(a.x);
  const T* res = static_cast<const T*>(a.res);
  const dim3 grid((unsigned)(row_blocks + item_blocks), tiles);
  rows<<<grid, kSpmmThreads, 0, a.stream>>>(
      a.row_ids, a.indptr, a.indices, a.vals, x, res, a.out, a.n_rows, a.d,
      a.add, a.keep, a.w, a.norm, L, a.long_slice, row_blocks, a.item_rows,
      a.item_starts, a.item_cuts, a.n_items, a.part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.n_split > 0) {
    const dim3 jgrid((unsigned)((a.n_split + teams - 1) / teams), tiles);
    join<<<jgrid, kSpmmThreads, 0, a.stream>>>(
        a.row_ids, a.item_rows, a.item_cuts, a.split, a.n_split, a.part, res,
        a.out, a.d, a.add, a.keep, a.w, a.norm, L);
  }
  return cudaGetLastError();
}

template <template <typename, bool, int> class K, typename T, bool kVec4>
cudaError_t spmm_launch_slots(const SpmmArgs& a, const Layout& lay) {
  switch (lay.slots) {
    case 1: return K<T, kVec4, 1>::launch(a, lay.L, lay.tiles);
    case 2: return K<T, kVec4, 2>::launch(a, lay.L, lay.tiles);
    case 4: return K<T, kVec4, 4>::launch(a, lay.L, lay.tiles);
    case 8: return K<T, kVec4, 8>::launch(a, lay.L, lay.tiles);
  }
  if constexpr (!kVec4) {
    if (lay.slots == 16) return K<T, kVec4, 16>::launch(a, lay.L, lay.tiles);
    if (lay.slots == 32) return K<T, kVec4, 32>::launch(a, lay.L, lay.tiles);
  }
  return cudaErrorInvalidValue;
}

// Launches the SpMM of `a` through the library's kernels K<T, kVec4, kS>
// (a struct whose launch(a, L, tiles) calls spmm_launch_tile) and returns
// the first cudaGetLastError() that is not 0 (cudaErrorInvalidValue for a
// normalisation of a row wider than one column tile).  A view with no rows
// (or d = 0) launches nothing.  vec4 requires d % 4 == 0, x and res aligned
// to 4 elements and out to 16 bytes (checked by the Python wrappers).
template <template <typename, bool, int> class K>
cudaError_t spmm_launch(const SpmmArgs& a, bool x_bf16, bool vec4) {
  if (a.n_rows <= 0 || a.d <= 0) return cudaGetLastError();
  const Layout lay = layout(a.d, vec4);
  if (a.norm != 0 && lay.tiles > 1) return cudaErrorInvalidValue;
  using B = __nv_bfloat16;
  if (x_bf16) {
    return vec4 ? spmm_launch_slots<K, B, true>(a, lay)
                : spmm_launch_slots<K, B, false>(a, lay);
  }
  return vec4 ? spmm_launch_slots<K, float, true>(a, lay)
              : spmm_launch_slots<K, float, false>(a, lay);
}

}  // namespace row_team
