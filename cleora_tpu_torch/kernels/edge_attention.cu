// K4: edge attention weights of one attention iteration, and the fused
// attention pass that replaces it on the main path, hand-written for Hopper
// (sm_90a).
//
// edge_attention_kernel (ops.edge_attention_weights, kept with its check)
// computes the weights alone; attention_rows / attention_join (the fused
// pass, ops.attention_spmm, its own launch counter) compute the whole
// iteration's propagate in one pass; see the note above attention_rows.
//
// Replaces the score, masked row softmax and reweighting part of the JAX
// package's attention_step (cleora_tpu/__init__.py:505-526).  For each row r
// of the CSR matrix and each of its edges e, with xn the row-L2-normalised
// state:
//
//   s_e    = <xn[r], xn[indices[e]]> / T                 (edges with vals != 0)
//   m      = max_e s_e, or 0 when the row has no such edge (or it is not finite)
//   p_e    = exp(s_e - m)                                 (0 where vals == 0)
//   a_e    = p_e / max(sum_e p_e, 1e-10) * vals[e]
//   out[e] = a_e / max(sum_e a_e, 1e-10)
//
// out then serves as the values of the propagate SpMM (kernel K1).
//
// Bound on the card: bytes.  Read once, a call moves xn (4 N D B), the CSR
// (8 (N+1) + 8 nnz B) and out (4 nnz B); it does 2 nnz D flops for the
// scores, a quarter of a flop per byte.  The gather it really needs is one
// row of xn per edge, nnz * 4 D B, as for K1.
//
// Design: one block of 128 threads per row.  Pass 1 gives each warp one edge
// at a time: the lanes take float4 column groups of xn[r] and xn[col] (one
// float at a time when D % 4 != 0), and a warp shuffle sums the dot product.
// The scores go to `out`, which is the row's scratch: a row of any degree
// (a hub of 50,000 edges) needs no shared buffer.  Passes 2-4 give each
// thread a strided share of the row's edges, always the same share, so each
// thread rewrites only what it read itself: max, then exp and its sum, then
// the reweighting and its sum, then the division.  Each reduction is a warp
// shuffle and one shared slot per warp.  expf (not __expf) and IEEE division
// keep the rounding of the plain version.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "row_team.cuh"

namespace {

constexpr int kThreads = 128;

template <bool VEC4>
__device__ __forceinline__ float warp_dot(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          int64_t d, int lane) {
  float s = 0.f;
  if (VEC4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int64_t g = lane; g < (d >> 2); g += 32) {
      const float4 u = __ldg(a4 + g);
      const float4 v = __ldg(b4 + g);
      s += u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
    }
  } else {
    for (int64_t c = lane; c < d; c += 32) s += __ldg(a + c) * __ldg(b + c);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// Reduces v over the block; every thread gets the result.  The leading
// barrier lets one `partial` buffer serve consecutive reductions.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* partial, Op op,
                                              float identity) {
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? partial[lane] : identity;
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
    edge_attention_kernel(const int64_t* __restrict__ indptr,
                          const int32_t* __restrict__ indices,
                          const float* __restrict__ vals,
                          const float* __restrict__ xn, float* __restrict__ out,
                          int64_t d, float temperature) {
  __shared__ float partial[32];
  const int64_t row = blockIdx.x;
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  if (start == end) return;  // the whole block leaves: no barrier is skipped
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const float* xr = xn + row * d;

  // pass 1: scores into out (masked edges get -inf; they are never read as
  // scores again, only their vals)
  for (int64_t e = start + warp; e < end; e += warps) {
    if (vals[e] != 0.f) {
      const float dot = warp_dot<VEC4>(xr, xn + (int64_t)indices[e] * d, d, lane);
      if (lane == 0) out[e] = dot / temperature;
    } else if (lane == 0) {
      out[e] = -INFINITY;
    }
  }
  __syncthreads();

  // pass 2: the row max over valid edges
  float m = -INFINITY;
  for (int64_t e = start + tid; e < end; e += blockDim.x) {
    if (vals[e] != 0.f) m = fmaxf(m, out[e]);
  }
  m = block_reduce(m, partial, Max(), -INFINITY);
  if (!isfinite(m)) m = 0.f;

  // pass 3: p_e = exp(s_e - m) and its sum
  float sp = 0.f;
  for (int64_t e = start + tid; e < end; e += blockDim.x) {
    const float p = vals[e] != 0.f ? expf(out[e] - m) : 0.f;
    out[e] = p;
    sp += p;
  }
  const float dp = fmaxf(block_reduce(sp, partial, Sum(), 0.f), 1e-10f);

  // pass 4: a_e = p_e / max(sum p, 1e-10) * vals[e] and its sum
  float sa = 0.f;
  for (int64_t e = start + tid; e < end; e += blockDim.x) {
    const float a = out[e] / dp * vals[e];
    out[e] = a;
    sa += a;
  }
  const float da = fmaxf(block_reduce(sa, partial, Sum(), 0.f), 1e-10f);

  for (int64_t e = start + tid; e < end; e += blockDim.x) out[e] = out[e] / da;
}

// ---- The fused attention pass: what cleora_tpu/__init__.py:501-534
// attention_step computes before its whitening, in one pass over the rows:
//
//   xn_r   = x[r] / max(||x[r]||, 1e-10)
//   s_e    = <xn_r, x[c_e]> / max(||x[c_e]||, 1e-10) / T   (vals[e] != 0)
//   y[r]   = (sum_e p_e v_e x[c_e] / max(P, 1e-10)) / max(PV / max(P, 1e-10), 1e-10)
//   with p_e = exp(s_e - max_e s_e), P = sum_e p_e, PV = sum_e p_e v_e,
//   then y[r] /= max(||y[r]||, 1e-10) for norm 1 (l2) or 2 (l1).
//
// This is the JAX code's masked softmax, reweighting and renormalisation
// (a row with no valid edge has max 0 and gives 0: P = PV = 0 and the
// clamps give y = 0), followed by its SpMM, with the divisions by the two
// clamped sums taken once a row instead of once an edge.
//
// Bound on the card: bytes.  Read once: x (4 N D B), the CSR (8 (N+1) +
// 8 nnz B); written once: y (4 N D B).  The gather it needs on a random
// graph is one x row per valid edge, as for K1.
//
// Design: K1's (a team of L lanes a row, S slots a lane, a chunk of (col,
// val) pairs loaded coalesced and broadcast, a batch of gathers in flight,
// the normalisation in the epilogue: row_team.cuh).  Each x[c_e] is
// gathered once; its sum of squares and its dot product with xn_r come
// from one interleaved pair of butterflies over the team.  The softmax is online, as in flash
// attention: a running reference m (the first batch's largest score,
// moved when a batch's largest exceeds it by more than kRescale) and,
// scaled to it, P, PV and the row sum acc = sum p v x[c]; moving m
// rescales the three by exp(m_old - m_new).  A batch's butterflies are
// independent of one another and run interleaved.  The scores use rsqrtf
// and the exponentials exp2f (a few ulp each, not K4's IEEE division and
// expf): the pass is held to its plain version at rtol=1e-5 all the same.  The old path's five passes (a float32 copy of x, K2 on it, K4's
// scores and weights through device memory, K1 gathering every x row a
// second time, K2 again) become one.  A hub row (more than long_slice
// entries) is cut into K1's interleaved slices; each slice leaves (m, P,
// PV) and acc in scratch, and attention_join merges a hub's slices in
// slice order with the same rescaling before the epilogue.

// The running reference m moves (to the largest score of a batch of edges)
// only when a score exceeds it by more than kRescale (p <= e^8 in
// between), so a row rescales its state about once, not at every new
// maximum, and the batch's exponentials do not wait on one another.  P >= 1 still holds once a valid edge is seen
// (the edge at the true maximum gives p >= 1), so the clamp on P binds
// exactly where JAX's does (no valid edge), and y, a ratio of sums, does
// not depend on the reference.
constexpr float kRescale = 8.f;
constexpr float kLog2e = 1.4426950408889634f;

// Blocks of 128 threads, and batches of a quarter of K1's edges (4 slot
// loads in flight a lane; 2 edges at D = 256): the batch's scores,
// butterflies and exponentials hold more registers than K1's sums, and
// more warps an SM hide the per-edge latency better than more edges a
// warp.  On an H100 at phase 5's shape (D = 256, l2): 6.06 ms, against
// 7.21 with batches of half K1's, 9.19 with K1's, 6.59 with half K1's and
// at least 6 blocks an SM, 8.88 with 256-thread blocks and 6.98 with
// 64-thread ones (scripts/torch_attention_probe.py).
constexpr int kAttThreads = 128;

template <bool kVec4, int kS>
struct AttTile {
  static constexpr int kP = kVec4 ? 4 : 1;
  static constexpr int kB = (kVec4 ? 4 : 8) / kS > 2 ? (kVec4 ? 4 : 8) / kS
                                                     : 2;
};

template <int kP>
__device__ __forceinline__ void att_load(float (&o)[kP], const float* p) {
  if constexpr (kP == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else {
    o[0] = __ldg(p);
  }
}

// The (m, P, PV, acc) state of a row or slice over its entries e0 + n *
// stride + [0, 32) below `end` (K1's walk).  xn holds the team's slots of
// xn_r.  Every lane of the warp calls this.
template <bool kVec4, int kS>
__device__ __forceinline__ void attention_walk(
    float (&acc)[kS][AttTile<kVec4, kS>::kP], float& m, float& sp,
    float& spv, const float (&xn)[kS][AttTile<kVec4, kS>::kP],
    const bool (&ok)[kS], const int32_t* __restrict__ indices,
    const float* __restrict__ vals, const float* __restrict__ x, int64_t d,
    float inv_t, int L, int sub, bool live, int64_t e0, int64_t stride,
    int64_t end) {
  constexpr int kP = AttTile<kVec4, kS>::kP;
  constexpr int kB = AttTile<kVec4, kS>::kB;
  const int per = 32 / L;
  for (int64_t i = 0;; ++i) {
    const int64_t b = e0 + (i / per) * stride + (i % per) * L;
    const bool more = live && b < end;
    if (!__any_sync(0xffffffffu, more)) break;
    const int k = more ? (int)(end - b < L ? end - b : L) : 0;
    int col = 0;
    float v = 0.f;
    if (sub < k) {
      col = __ldg(indices + b + sub);
      v = __ldg(vals + b + sub);
    }
    const int kmax = (int)__reduce_max_sync(0xffffffffu, (unsigned)k);
    for (int j = 0; j < kmax; j += kB) {
      float g[kB][kS][kP];
      float vj[kB];
      bool valid[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int cj = __shfl_sync(0xffffffffu, col, j + u, L);
        vj[u] = __shfl_sync(0xffffffffu, v, j + u, L);
        valid[u] = j + u < k && vj[u] != 0.f;
        const float* xr = x + (int64_t)cj * d;
#pragma unroll
        for (int t = 0; t < kS; ++t) {
          if (valid[u] && ok[t]) {
            att_load<kP>(g[u][t], xr + (int64_t)(sub + L * t) * kP);
          } else {
#pragma unroll
            for (int q = 0; q < kP; ++q) g[u][t][q] = 0.f;
          }
        }
      }
      // the batch's scores: the dot products and sums of squares of all
      // its edges, reduced together (independent butterflies)
      float dot[kB], ss[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        dot[u] = 0.f;
        ss[u] = 0.f;
#pragma unroll
        for (int t = 0; t < kS; ++t)
#pragma unroll
          for (int q = 0; q < kP; ++q) {
            dot[u] += xn[t][q] * g[u][t][q];
            ss[u] += g[u][t][q] * g[u][t][q];
          }
      }
      for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off, L);
          ss[u] += __shfl_xor_sync(0xffffffffu, ss[u], off, L);
        }
      }
      float s[kB];
      float mb = -INFINITY;
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        // <xn_r, x_c> / max(||x_c||, 1e-10) / T
        s[u] = dot[u] * rsqrtf(fmaxf(ss[u], 1e-20f)) * inv_t;
        if (valid[u]) mb = fmaxf(mb, s[u]);
      }
      if (mb > m + kRescale) {  // team-uniform
        const float f = exp2f((m - mb) * kLog2e);  // 0 while m is -inf
        sp *= f;
        spv *= f;
#pragma unroll
        for (int t = 0; t < kS; ++t)
#pragma unroll
          for (int q = 0; q < kP; ++q) acc[t][q] *= f;
        m = mb;
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (!valid[u]) continue;  // team-uniform
        const float p = exp2f((s[u] - m) * kLog2e);
        const float pv = p * vj[u];
        sp += p;
        spv += pv;
#pragma unroll
        for (int t = 0; t < kS; ++t)
#pragma unroll
          for (int q = 0; q < kP; ++q) acc[t][q] += pv * g[u][t][q];
      }
    }
  }
}

// xn_r: the team's slots of x[row] over its l2 norm.
template <bool kVec4, int kS>
__device__ __forceinline__ void normed_row(
    float (&xn)[kS][AttTile<kVec4, kS>::kP], const bool (&ok)[kS],
    const float* __restrict__ xr, int L, int sub, bool live) {
  constexpr int kP = AttTile<kVec4, kS>::kP;
  float ss = 0.f;
#pragma unroll
  for (int t = 0; t < kS; ++t) {
    if (live && ok[t]) {
      att_load<kP>(xn[t], xr + (int64_t)(sub + L * t) * kP);
    } else {
#pragma unroll
      for (int q = 0; q < kP; ++q) xn[t][q] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < kP; ++q) ss += xn[t][q] * xn[t][q];
  }
  for (int off = L >> 1; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off, L);
  const float denom = fmaxf(sqrtf(ss), 1e-10f);
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q) xn[t][q] /= denom;
}

// y from the row's state, normalised (norm 1 l2, 2 l1: row_team.cuh's
// epilogue, K1's) and stored.
template <bool kVec4, int kS>
__device__ __forceinline__ void attention_finish(
    float (&acc)[kS][AttTile<kVec4, kS>::kP], float sp, float spv,
    const bool (&ok)[kS], float* out_row, int norm, int L, int sub,
    bool live) {
  constexpr int kP = AttTile<kVec4, kS>::kP;
  const float dp = fmaxf(sp, 1e-10f);
  const float da = fmaxf(spv / dp, 1e-10f);
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q) acc[t][q] = acc[t][q] / dp / da;
  row_team::normalize_team<kS, kP>(acc, norm, L);
  if (live) row_team::store_team<kS, kP>(acc, ok, out_row, L, sub);
}

// Blocks [0, row_blocks) take the rows, a team each (rows of more than
// long_slice entries are left to their slices); the blocks after them
// take the n_items slices, which leave acc in `part` and (m, P, PV) in
// `stats`.
template <bool kVec4, int kS>
__global__ void __launch_bounds__(kAttThreads)
    attention_rows(const int64_t* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const float* __restrict__ vals,
                   const float* __restrict__ x, float* __restrict__ out,
                   int64_t n_rows, int64_t d, float temperature, int norm,
                   int L, int64_t long_slice, int64_t row_blocks,
                   const int32_t* __restrict__ item_rows,
                   const int64_t* __restrict__ item_starts,
                   const int32_t* __restrict__ item_cuts, int64_t n_items,
                   float* __restrict__ part, float* __restrict__ stats) {
  constexpr int kP = AttTile<kVec4, kS>::kP;
  const int sub = threadIdx.x & (L - 1);
  const bool rows = (int64_t)blockIdx.x < row_blocks;
  const int64_t team =
      ((int64_t)blockIdx.x - (rows ? 0 : row_blocks)) * (kAttThreads / L) +
      threadIdx.x / L;
  bool ok[kS];
#pragma unroll
  for (int t = 0; t < kS; ++t) ok[t] = (int64_t)(sub + L * t) * kP < d;
  bool live;
  int64_t row = 0, e0 = 0, stride = 32, end = 0;
  if (rows) {
    const bool in = team < n_rows;
    if (in) {
      row = team;
      e0 = __ldg(indptr + team);
      end = __ldg(indptr + team + 1);
    }
    live = in && end - e0 <= long_slice;
  } else {
    live = team < n_items;
    if (live) {
      row = __ldg(item_rows + team);
      e0 = __ldg(item_starts + team);
      stride = 32 * (int64_t)__ldg(item_cuts + team);
      end = __ldg(indptr + row + 1);
    }
  }
  float xn[kS][kP];
  normed_row<kVec4, kS>(xn, ok, x + row * d, L, sub, live);
  float acc[kS][kP];
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q) acc[t][q] = 0.f;
  float m = -INFINITY, sp = 0.f, spv = 0.f;
  attention_walk<kVec4, kS>(acc, m, sp, spv, xn, ok, indices, vals, x, d,
                            1.f / temperature, L, sub, live, e0, stride,
                            end);
  if (rows) {
    attention_finish<kVec4, kS>(acc, sp, spv, ok, out + row * d, norm, L,
                                sub, live);
    return;
  }
  if (!live) return;
  if (sub == 0) {
    stats[3 * team] = m;
    stats[3 * team + 1] = sp;
    stats[3 * team + 2] = spv;
  }
#pragma unroll
  for (int t = 0; t < kS; ++t) {
    if (!ok[t]) continue;
    float* p = part + team * d + (int64_t)(sub + L * t) * kP;
#pragma unroll
    for (int q = 0; q < kP; ++q) p[q] = acc[t][q];
  }
}

// A team a hub row: its slices' states merged in slice order with the
// online rescaling, then the epilogue.
template <bool kVec4, int kS>
__global__ void __launch_bounds__(kAttThreads)
    attention_join(const int32_t* __restrict__ item_rows,
                   const int32_t* __restrict__ item_cuts,
                   const int32_t* __restrict__ split, int64_t n_split,
                   const float* __restrict__ part,
                   const float* __restrict__ stats, float* __restrict__ out,
                   int64_t d, int norm, int L) {
  constexpr int kP = AttTile<kVec4, kS>::kP;
  const int sub = threadIdx.x & (L - 1);
  const int64_t h = (int64_t)blockIdx.x * (kAttThreads / L) + threadIdx.x / L;
  const bool live = h < n_split;
  bool ok[kS];
#pragma unroll
  for (int t = 0; t < kS; ++t) ok[t] = (int64_t)(sub + L * t) * kP < d;
  float acc[kS][kP];
#pragma unroll
  for (int t = 0; t < kS; ++t)
#pragma unroll
    for (int q = 0; q < kP; ++q) acc[t][q] = 0.f;
  float m = -INFINITY, sp = 0.f, spv = 0.f;
  int64_t row = 0;
  if (live) {
    const int64_t w0 = __ldg(split + h);
    const int cuts = __ldg(item_cuts + w0);
    row = __ldg(item_rows + w0);
    for (int j = 0; j < cuts; ++j) {
      const int64_t wj = w0 + j;
      const float mj = stats[3 * wj];
      if (mj == -INFINITY) continue;  // a slice with no valid edge
      if (mj > m) {
        const float f = exp2f((m - mj) * kLog2e);
        sp *= f;
        spv *= f;
#pragma unroll
        for (int t = 0; t < kS; ++t)
#pragma unroll
          for (int q = 0; q < kP; ++q) acc[t][q] *= f;
        m = mj;
      }
      const float f = exp2f((mj - m) * kLog2e);
      sp += stats[3 * wj + 1] * f;
      spv += stats[3 * wj + 2] * f;
      const float* p = part + wj * d;
#pragma unroll
      for (int t = 0; t < kS; ++t) {
        if (!ok[t]) continue;
#pragma unroll
        for (int q = 0; q < kP; ++q)
          acc[t][q] += p[(int64_t)(sub + L * t) * kP + q] * f;
      }
    }
  }
  attention_finish<kVec4, kS>(acc, sp, spv, ok, out + row * d, norm, L, sub,
                              live);
}

struct AttArgs {
  const int64_t* indptr;
  const int32_t* indices;
  const float* vals;
  const float* x;
  float* out;
  int64_t n_rows, d;
  float temperature;
  int norm, L;
  int64_t long_slice;
  const int32_t* item_rows;
  const int64_t* item_starts;
  const int32_t* item_cuts;
  int64_t n_items;
  const int32_t* split;
  int64_t n_split;
  float* part;
  float* stats;
  cudaStream_t stream;
};

template <bool kVec4, int kS>
cudaError_t attention_launch_slots(const AttArgs& a) {
  const int64_t teams = kAttThreads / a.L;
  const int64_t row_blocks = (a.n_rows + teams - 1) / teams;
  const int64_t item_blocks = (a.n_items + teams - 1) / teams;
  if (row_blocks + item_blocks > 0) {
    attention_rows<kVec4, kS>
        <<<(unsigned)(row_blocks + item_blocks), kAttThreads, 0, a.stream>>>(
            a.indptr, a.indices, a.vals, a.x, a.out, a.n_rows, a.d,
            a.temperature, a.norm, a.L, a.long_slice, row_blocks,
            a.item_rows, a.item_starts, a.item_cuts, a.n_items, a.part,
            a.stats);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.n_split > 0) {
    attention_join<kVec4, kS>
        <<<(unsigned)((a.n_split + teams - 1) / teams), kAttThreads, 0, a.stream>>>(
            a.item_rows, a.item_cuts, a.split, a.n_split, a.part, a.stats,
            a.out, a.d, a.norm, a.L);
  }
  return cudaGetLastError();
}

template <bool kVec4>
cudaError_t attention_dispatch(const AttArgs& a, int slots) {
  switch (slots) {
    case 1: return attention_launch_slots<kVec4, 1>(a);
    case 2: return attention_launch_slots<kVec4, 2>(a);
    case 4: return attention_launch_slots<kVec4, 4>(a);
    case 8: return attention_launch_slots<kVec4, 8>(a);
  }
  if constexpr (!kVec4) {
    if (slots == 16) return attention_launch_slots<kVec4, 16>(a);
    if (slots == 32) return attention_launch_slots<kVec4, 32>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError().  `vec4` requires
// d % 4 == 0 and xn 16-byte aligned (checked by the Python wrapper).  Rows
// index the grid's x dimension (at most 2^31 - 1).
extern "C" int edge_attention_launch(const int64_t* indptr,
                                     const int32_t* indices, const float* vals,
                                     const float* xn, float* out,
                                     int64_t n_rows, int64_t d,
                                     float temperature, int vec4,
                                     void* stream) {
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((unsigned)n_rows);
    if (vec4) {
      edge_attention_kernel<true><<<grid, kThreads, 0, s>>>(
          indptr, indices, vals, xn, out, d, temperature);
    } else {
      edge_attention_kernel<false><<<grid, kThreads, 0, s>>>(
          indptr, indices, vals, xn, out, d, temperature);
    }
  }
  return (int)cudaGetLastError();
}

// Launches the fused attention pass on `stream` and returns the first
// cudaGetLastError() that is not 0 (cudaErrorInvalidValue for d > 1024).
// x is float32 (N, D), out a new float32 (N, D); norm 0 none, 1 l2, 2 l1.
// `vec4` requires d % 4 == 0 and x and out 16-byte aligned (checked by the
// Python wrapper).  Rows of more than `long_slice` entries are taken by the
// n_items slices of kernels.HubPlan (split: the first slice of each of the
// n_split hub rows), which need n_items * d float32 of scratch in `part`
// and 3 n_items in `stats`; pass long_slice = INT64_MAX and no items to
// walk every row with its own team.
extern "C" int attention_spmm_launch(
    const int64_t* indptr, const int32_t* indices, const float* vals,
    const float* x, float* out, int64_t n_rows, int64_t d, float temperature,
    int norm, int vec4, int64_t long_slice, const int32_t* item_rows,
    const int64_t* item_starts, const int32_t* item_cuts, int64_t n_items,
    const int32_t* split, int64_t n_split, float* part, float* stats,
    void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaGetLastError();
  if (d > row_team::kMaxColumns) return (int)cudaErrorInvalidValue;
  const row_team::Layout lay = row_team::layout(d, vec4);
  AttArgs a{indptr, indices, vals, x, out, n_rows, d, temperature, norm,
            lay.L, long_slice, item_rows, item_starts, item_cuts, n_items,
            split, n_split, part, stats, static_cast<cudaStream_t>(stream)};
  return (int)(vec4 ? attention_dispatch<true>(a, lay.slots)
                    : attention_dispatch<false>(a, lay.slots));
}
