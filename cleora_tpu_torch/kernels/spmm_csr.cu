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
// Design.  A team of L lanes (a whole warp from D = 128 on; for narrower
// rows the smallest power of two that gives each lane a column group, so
// a warp serves 32 / L rows) owns an output row.  Each lane holds S slots
// of 4 columns (one float4, or 4 bf16 in 8 bytes) or, when D % 4 != 0, of
// one column; D <= 1024 is one column tile, a wider row is cut into tiles
// of 1024 columns (grid.y), which cannot normalise and leave that to K2.
// The team loads its row's next L (col, val) pairs in one coalesced load,
// broadcasts them with __shfl_sync, and issues the gathers of a batch of
// kB edges together, predicated, before it adds them in edge order, so a
// short row (6-7 entries on the phase-5 graph) waits on one round of
// memory latency.  The sum stays in registers; the epilogue mixes the
// residual, takes the row's sum of squares (or of absolute values) with one
// butterfly of shuffles over the team, divides and writes the row once, so
// the separate K2 pass over the state (a read and a write of it) is gone.
// The layout and that normalisation are row_team.cuh's, which K2 and the
// fused attention pass share.
// Loop control is warp-uniform (__any_sync / __reduce_max_sync), so the
// shuffles run with the full mask even when a warp holds several teams.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_team.cuh"

namespace {

using row_team::kAll;
constexpr int kThreads = 256;

template <bool kVec4>
struct Cols {
  static constexpr int kP = kVec4 ? 4 : 1;        // columns a slot
  static constexpr int kLoads = kVec4 ? 16 : 32;  // slot loads in flight a lane
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
// `end`, walked L at a time.  A row is stride 32 (every chunk); slice j of
// K is e0 = row start + 32 j, stride 32 K.  Every lane of the warp calls
// this, `live` or not.
template <typename T, bool kVec4, int kS>
__device__ __forceinline__ void gather_sum(
    float (&acc)[kS][Cols<kVec4>::kP], const bool (&ok)[kS],
    const int32_t* __restrict__ indices, const float* __restrict__ vals,
    const T* __restrict__ x, int64_t d, int64_t c0, int L, int sub, bool live,
    int64_t e0, int64_t stride, int64_t end) {
  constexpr int kP = Cols<kVec4>::kP;
  constexpr int kB = Cols<kVec4>::kLoads / kS > 2 ? Cols<kVec4>::kLoads / kS
                                                  : 2;  // edges in flight
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
  row_team::normalize_team<kS, kP>(acc, norm, L);
  if (live) row_team::store_team<kS, kP>(acc, ok, out_row, L, sub);
}

template <bool kVec4, int kS>
__device__ __forceinline__ void slots_ok(bool (&ok)[kS], int64_t c0,
                                         int64_t d, int L, int sub) {
#pragma unroll
  for (int t = 0; t < kS; ++t)
    ok[t] = c0 + (int64_t)(sub + L * t) * Cols<kVec4>::kP < d;
}

// Blocks [0, row_blocks) walk the rows, a team each (a row of more than
// long_slice entries is left to its slices); the blocks after them walk
// the n_items slices of the hub rows into `part`.
template <typename T, bool kVec4, int kS>
__global__ void __launch_bounds__(kThreads)
    spmm_csr_rows(const int64_t* __restrict__ indptr,
                  const int32_t* __restrict__ indices,
                  const float* __restrict__ vals, const T* __restrict__ x,
                  const T* __restrict__ res, float* __restrict__ out,
                  int64_t n_rows, int64_t d, float keep, float w, int norm,
                  int L, int64_t long_slice, int64_t row_blocks,
                  const int32_t* __restrict__ item_rows,
                  const int64_t* __restrict__ item_starts,
                  const int32_t* __restrict__ item_cuts, int64_t n_items,
                  float* __restrict__ part) {
  constexpr int kP = Cols<kVec4>::kP;
  const int sub = threadIdx.x & (L - 1);
  const bool rows = (int64_t)blockIdx.x < row_blocks;
  const int64_t team =
      ((int64_t)blockIdx.x - (rows ? 0 : row_blocks)) * (kThreads / L) +
      threadIdx.x / L;
  const int64_t c0 = (int64_t)blockIdx.y * L * kS * kP;
  bool ok[kS];
  slots_ok<kVec4, kS>(ok, c0, d, L, sub);
  float acc[kS][kP];
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q) acc[t][q] = 0.f;
  if (rows) {
    const bool in = team < n_rows;
    const int64_t start = in ? __ldg(indptr + team) : 0;
    const int64_t end = in ? __ldg(indptr + team + 1) : 0;
    const bool live = in && end - start <= long_slice;
    gather_sum<T, kVec4, kS>(acc, ok, indices, vals, x, d, c0, L, sub, live,
                             start, 32, end);
    const int64_t row = live ? team : 0;
    finish<T, kVec4, kS>(acc, ok, res + row * d + c0, out + row * d + c0,
                         keep, w, norm, L, sub, live);
  } else {
    const bool live = team < n_items;
    int64_t e0 = 0, stride = 32, end = 0;
    if (live) {
      e0 = __ldg(item_starts + team);
      stride = 32 * (int64_t)__ldg(item_cuts + team);
      end = __ldg(indptr + __ldg(item_rows + team) + 1);
    }
    gather_sum<T, kVec4, kS>(acc, ok, indices, vals, x, d, c0, L, sub, live,
                             e0, stride, end);
    if (!live) return;
#pragma unroll
    for (int t = 0; t < kS; ++t) {
      if (!ok[t]) continue;
      float* p = part + team * d + c0 + (int64_t)(sub + L * t) * kP;
#pragma unroll
      for (int q = 0; q < kP; ++q) p[q] = acc[t][q];
    }
  }
}

// A team a hub row: its slices' sums added in slice order, then the
// epilogue.  split[h] is the first slice of hub h.
template <typename T, bool kVec4, int kS>
__global__ void __launch_bounds__(kThreads)
    spmm_csr_join(const int32_t* __restrict__ item_rows,
                  const int32_t* __restrict__ item_cuts,
                  const int32_t* __restrict__ split, int64_t n_split,
                  const float* __restrict__ part, const T* __restrict__ res,
                  float* __restrict__ out, int64_t d, float keep, float w,
                  int norm, int L) {
  constexpr int kP = Cols<kVec4>::kP;
  const int sub = threadIdx.x & (L - 1);
  const int64_t h = (int64_t)blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const int64_t c0 = (int64_t)blockIdx.y * L * kS * kP;
  const bool live = h < n_split;
  bool ok[kS];
  slots_ok<kVec4, kS>(ok, c0, d, L, sub);
  float acc[kS][kP];
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q) acc[t][q] = 0.f;
  int64_t row = 0;
  if (live) {
    const int64_t w0 = __ldg(split + h);
    const int cuts = __ldg(item_cuts + w0);
    row = __ldg(item_rows + w0);
    for (int j = 0; j < cuts; ++j) {
      const float* p = part + (w0 + j) * d + c0;
#pragma unroll
      for (int t = 0; t < kS; ++t) {
        if (!ok[t]) continue;
#pragma unroll
        for (int q = 0; q < kP; ++q)
          acc[t][q] += p[(int64_t)(sub + L * t) * kP + q];
      }
    }
  }
  finish<T, kVec4, kS>(acc, ok, res + row * d + c0, out + row * d + c0, keep,
                       w, norm, L, sub, live);
}

struct Args {
  const int64_t* indptr;
  const int32_t* indices;
  const float* vals;
  const void* x;
  const void* res;
  float* out;
  int64_t n_rows, d;
  float keep, w;
  int norm, L;
  int64_t long_slice;
  const int32_t* item_rows;
  const int64_t* item_starts;
  const int32_t* item_cuts;
  int64_t n_items;
  const int32_t* split;
  int64_t n_split;
  float* part;
  unsigned tiles;
  cudaStream_t stream;
};

template <typename T, bool kVec4, int kS>
cudaError_t launch(const Args& a) {
  const int64_t teams = kThreads / a.L;
  const int64_t row_blocks = (a.n_rows + teams - 1) / teams;
  const int64_t item_blocks = (a.n_items + teams - 1) / teams;
  const T* x = static_cast<const T*>(a.x);
  const T* res = static_cast<const T*>(a.res);
  if (row_blocks + item_blocks > 0) {
    const dim3 grid((unsigned)(row_blocks + item_blocks), a.tiles);
    spmm_csr_rows<T, kVec4, kS><<<grid, kThreads, 0, a.stream>>>(
        a.indptr, a.indices, a.vals, x, res, a.out, a.n_rows, a.d, a.keep,
        a.w, a.norm, a.L, a.long_slice, row_blocks, a.item_rows,
        a.item_starts, a.item_cuts, a.n_items, a.part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.n_split > 0) {
    const dim3 grid((unsigned)((a.n_split + teams - 1) / teams), a.tiles);
    spmm_csr_join<T, kVec4, kS><<<grid, kThreads, 0, a.stream>>>(
        a.item_rows, a.item_cuts, a.split, a.n_split, a.part, res, a.out,
        a.d, a.keep, a.w, a.norm, a.L);
  }
  return cudaGetLastError();
}

template <typename T, bool kVec4>
cudaError_t launch_slots(const Args& a, int slots) {
  switch (slots) {
    case 1: return launch<T, kVec4, 1>(a);
    case 2: return launch<T, kVec4, 2>(a);
    case 4: return launch<T, kVec4, 4>(a);
    case 8: return launch<T, kVec4, 8>(a);
  }
  if constexpr (!kVec4) {
    if (slots == 16) return launch<T, kVec4, 16>(a);
    if (slots == 32) return launch<T, kVec4, 32>(a);
  }
  return cudaErrorInvalidValue;
}

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
  if (n_rows <= 0 || d <= 0) return (int)cudaGetLastError();
  const row_team::Layout lay = row_team::layout(d, vec4);
  if (norm != 0 && lay.tiles > 1) return (int)cudaErrorInvalidValue;
  Args a{indptr, indices, vals, x, res, out, n_rows, d, keep, w, norm,
         lay.L, long_slice, item_rows, item_starts, item_cuts, n_items,
         split, n_split, part, lay.tiles, static_cast<cudaStream_t>(stream)};
  const int slots = lay.slots;
  cudaError_t err;
  if (x_bf16) {
    err = vec4 ? launch_slots<__nv_bfloat16, true>(a, slots)
               : launch_slots<__nv_bfloat16, false>(a, slots);
  } else {
    err = vec4 ? launch_slots<float, true>(a, slots)
               : launch_slots<float, false>(a, slots);
  }
  return (int)err;
}
