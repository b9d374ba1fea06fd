// K4: edge attention weights of one attention iteration, and the fused
// attention pass that replaces it on the main path up to 1,024 columns,
// hand-written for Hopper (sm_90a).
//
// edge_attention_kernel (ops.edge_attention_weights) computes the weights
// alone, for rows of any width (the attention step past
// kernels.FUSED_NORM_MAX_WIDTH = 1,024 columns: K4 -> K1 -> K2 -> whiten);
// attention_rows / attention_join (the fused pass, ops.attention_spmm, its
// own launch counter) compute the whole iteration's propagate in one pass;
// see the note above attention_rows.
//
// Replaces the score, masked row softmax and reweighting part of the JAX
// package's attention_step (cleora_tpu/__init__.py:505-526).  For each row r
// of the CSR matrix and each of its edges e, with x the raw state and
// xn = x / max(||x||, 1e-10) row by row:
//
//   s_e    = <xn[r], xn[indices[e]]> / T                 (edges with vals != 0)
//   m      = max_e s_e, or 0 when the row has no such edge (or it is not finite)
//   p_e    = exp(s_e - m)                                 (0 where vals == 0)
//   a_e    = p_e / max(sum_e p_e, 1e-10) * vals[e]
//   out[e] = a_e / max(sum_e a_e, 1e-10)
//
// out then serves as the values of the propagate SpMM (kernel K1).  K4
// reads x itself and normalises in registers: the attention step keeps no
// normalised copy of x (the first design read K2's output on a float32
// copy of x, a full read and write of x and one K2 more an iteration).
//
// Bound on the card: bytes.  Read once, a call moves x (4 N D B), the CSR
// (8 (N+1) + 8 nnz B) and out (4 nnz B); it does 4 nnz D flops for the
// scores and the sums of squares, half a flop per byte.  The gather it
// really needs on a random graph is one row of x a valid edge, nnz * 4 D
// B, as for K1 (chip_smoke.py logs both).
//
// Design: K1's row team (row_team.cuh's layout): a team of L lanes a row, a
// whole warp from 32 column groups (128 columns) on, a power of two of
// lanes below; a group is a float4 when D % 4 == 0, else one column.  A
// lane holds the fewest slots of the row that the compiled set offers
// (1, 2, 3, 4, 6, 8, 9, 12 or 16 float4s: D = 1,028 takes 9, so no
// register is spent on slots past the row); a row wider than 2,048
// columns (1,024 single columns) is walked in tiles of that width.  The
// team loads its row's next L (col, val) pairs in one coalesced load,
// broadcasts them with __shfl_sync and gathers a batch of edges' rows at
// once; each gathered x[c] gives its dot product with x[r] and its own
// sum of squares from one interleaved pair of butterflies over the team,
// q_e = <x[r], x[c]> / max(||x[c]||, 1e-10), and s_e = q_e / max(||x[r]||,
// 1e-10) / T once the row is gathered (||x[r]|| is taken last, so the
// loads of x[r] overlap the first gathers; the scale is positive, so the
// max of the q_e gives m).  The lane that holds an entry keeps its q in a
// register (the last kK4Chunks chunks of L entries of the row; a longer
// row keeps its earlier chunks' in `out`, each lane reading back only
// what it wrote itself); the row max, the exponentials and their sum, the
// reweighting and its sum, and the division are each a pass over a lane's
// own registers and a butterfly over the team: no block barrier and no
// shared memory, and the weights are written once.  The teams walk the
// rows persistently (a grid of as many blocks as the card holds at once),
// and a team loads the next row's extent and first chunk of (col, val)
// while it gathers its row's last chunk.  A hub row (more than
// long_slice entries: kernels.HubPlan, K1's cut) is scored in K1's
// interleaved slices, a team each, which leave its q in `out` and their
// share of its softmax (the fused pass's online (m, P, PV) state) in
// scratch; a thread a hub merges them, and the slices write its weights.
// On phase 5's power-law graph (rows of up to 333,156 entries) at D = 256
// / 1,028 that took 7.0 / 18.6 ms (floors 4.0 / 16.0), one team a row
// 180 / 283 ms and the first design, four warps a row, 78.6 / 144 ms
// (NVIDIA H100 80GB HBM3, 700.00 W, scripts/torch_k4_k6_probe.py).  expf
// and IEEE division, as the plain version.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "row_team.cuh"

namespace {

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

// ---- K4: the weights alone, over the raw state (the note at the top)

// Threads a block: 256 / L teams a block (blocks of 128 ran 0.6-16 %
// slower at D = 256 and within 1 % at D = 1,028 on an H100:
// scripts/torch_k4_k6_probe.py).
constexpr int kK4Threads = 256;
// Edges a batch of gathers: kK4Loads / kS slots' worth, 1 to 8 (one edge
// from 2 slots a lane on): with the persistent teams and the loads ahead,
// fewer registers and more teams an SM beat more edges in flight a team.
// On an H100 (scripts/torch_k4_k6_probe.py, NVIDIA H100 80GB HBM3,
// 700.00 W): at D = 1,028 (9 slots) on phase 4's graph 1 edge 0.148-0.150
// ms, 2 0.184, 3 0.172; at D = 256 (2 slots) on phase 5's 1 edge 4.93 ms,
// 2 5.21, 4 5.40, 8 5.99.
constexpr int kK4Loads = 2;
// Edges a batch in a hub's slices: kK4SliceLoads / kS slots' worth, at
// least the rows' batch, at most 8.  A slice walks up to 4,096 entries
// in one chain of batches, and the slices are few: registers matter less
// than the chain's length there (on the power-law graph at D = 1,028, 3
// edges a batch 18.6 ms, 1 edge 25.6; at D = 256, 8 edges 7.0, 1 edge
// 8.6: scripts/torch_k4_k6_probe.py, NVIDIA H100 80GB HBM3, 700.00 W).
constexpr int kK4SliceLoads = 32;
// Chunks of L entries whose scores a lane holds in registers (the row's
// last ones); a row of more chunks keeps its earlier chunks' in `out`.
constexpr int kK4Chunks = 4;
constexpr unsigned kK4All = 0xffffffffu;
// Slots a lane in one column tile: 2,048 columns in float4 groups, 1,024
// in single columns.
template <bool kVec4>
struct K4Max {
  static constexpr int kS = kVec4 ? 16 : 32;
};

template <bool kVec4, int kS>
struct K4Tile {
  static constexpr int kP = kVec4 ? 4 : 1;
  static constexpr int kB =
      kK4Loads / kS > 8 ? 8 : (kK4Loads / kS < 1 ? 1 : kK4Loads / kS);
  static constexpr int kSliceB =
      kK4SliceLoads / kS > 8 ? 8
                             : (kK4SliceLoads / kS < kB ? kB
                                                        : kK4SliceLoads / kS);
};

// Loads the team's slots of row + c0 (zero past d, or everywhere when not
// live).
template <int kS, int kP>
__device__ __forceinline__ void k4_slots(float (&o)[kS][kP],
                                         const float* __restrict__ row,
                                         int64_t c0, int64_t d, int L,
                                         int sub, bool live) {
#pragma unroll
  for (int t = 0; t < kS; ++t) {
    const int64_t c = c0 + (int64_t)(sub + L * t) * kP;
    if (live && c < d) {
      att_load<kP>(o[t], row + c);
    } else {
#pragma unroll
      for (int q = 0; q < kP; ++q) o[t][q] = 0.f;
    }
  }
}

// The scores' numerators of a chunk of k entries (lane sub's: col, v),
// q = <x[r], x[c]> / max(||x[c]||, 1e-10), in batches of kB edges: returns
// this lane's q (-inf where its entry is masked or past the chunk) and
// raises mq to the chunk's largest valid q.  x0 holds x[r] (kOne), else
// x[r]'s tiles are read from xr.  Every lane of the warp calls this.
template <bool kVec4, int kS, bool kOne, int kB>
__device__ __forceinline__ float k4_chunk(
    float& mq, int col, float v, int k,
    const float (&x0)[kS][K4Tile<kVec4, kS>::kP], const float* xr,
    const float* __restrict__ x, int64_t d, int L, int sub, bool live,
    int n_tiles) {
  constexpr int kP = K4Tile<kVec4, kS>::kP;
  const int64_t tile_cols = (int64_t)L * kS * kP;
  const int kmax = (int)__reduce_max_sync(kK4All, (unsigned)k);
  float mine = -INFINITY;
  for (int j = 0; j < kmax; j += kB) {
    const float* xc[kB];
    bool valid[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int cj = __shfl_sync(kK4All, col, j + u, L);
      const float vj = __shfl_sync(kK4All, v, j + u, L);
      valid[u] = j + u < k && vj != 0.f;
      xc[u] = x + (int64_t)cj * d;
    }
    float dot[kB], ss[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      dot[u] = 0.f;
      ss[u] = 0.f;
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int64_t c0 = tile * tile_cols;
      float g[kB][kS][kP];
#pragma unroll
      for (int u = 0; u < kB; ++u)
        k4_slots<kS, kP>(g[u], xc[u], c0, d, L, sub, valid[u]);
      float xt[kS][kP];
      if constexpr (kOne) {
#pragma unroll
        for (int t = 0; t < kS; ++t)
#pragma unroll
          for (int q = 0; q < kP; ++q) xt[t][q] = x0[t][q];
      } else {
        k4_slots<kS, kP>(xt, xr, c0, d, L, sub, live);
      }
#pragma unroll
      for (int u = 0; u < kB; ++u)
#pragma unroll
        for (int t = 0; t < kS; ++t)
#pragma unroll
          for (int q = 0; q < kP; ++q) {
            dot[u] += xt[t][q] * g[u][t][q];
            ss[u] += g[u][t][q] * g[u][t][q];
          }
    }
    for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        dot[u] += __shfl_xor_sync(kK4All, dot[u], off, L);
        ss[u] += __shfl_xor_sync(kK4All, ss[u], off, L);
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const float q = dot[u] / fmaxf(sqrtf(ss[u]), 1e-10f);
      if (valid[u]) {  // team-uniform
        mq = fmaxf(mq, q);
        if (sub == j + u) mine = q;
      }
    }
  }
  return mine;
}

// max(||x[r]||, 1e-10) over the team (x0: x[r] when kOne).  Every lane of
// the warp calls this.
template <bool kVec4, int kS, bool kOne>
__device__ __forceinline__ float k4_row_norm(
    const float (&x0)[kS][K4Tile<kVec4, kS>::kP], const float* xr,
    int64_t d, int L, int sub, bool live, int n_tiles) {
  constexpr int kP = K4Tile<kVec4, kS>::kP;
  float ss = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    float xt[kS][kP];
    if constexpr (kOne) {
#pragma unroll
      for (int t = 0; t < kS; ++t)
#pragma unroll
        for (int q = 0; q < kP; ++q) xt[t][q] = x0[t][q];
    } else {
      k4_slots<kS, kP>(xt, xr, tile * (int64_t)L * kS * kP, d, L, sub, live);
    }
#pragma unroll
    for (int t = 0; t < kS; ++t)
#pragma unroll
      for (int q = 0; q < kP; ++q) ss += xt[t][q] * xt[t][q];
  }
  for (int off = L >> 1; off > 0; off >>= 1)
    ss += __shfl_xor_sync(kK4All, ss, off, L);
  return fmaxf(sqrtf(ss), 1e-10f);
}

// The teams walk the rows of at most long_slice entries persistently
// (row, row + all teams, ...; a longer row is left to its slices and its
// join): while a row's last chunk is gathered, the team already loads the
// next row's extent and its first chunk of (col, val), so a row's setup
// does not wait on its own loads.  kOne: the row is one column tile (x[r]
// stays in registers), else `tiles` tiles of kS slots a lane.
template <bool kVec4, int kS, bool kOne>
__global__ void __launch_bounds__(kK4Threads)
    edge_attention_kernel(const int64_t* __restrict__ indptr,
                          const int32_t* __restrict__ indices,
                          const float* __restrict__ vals,
                          const float* __restrict__ x, float* __restrict__ out,
                          int64_t n_rows, int64_t d, float temperature, int L,
                          int tiles, int64_t long_slice) {
  constexpr int kP = K4Tile<kVec4, kS>::kP;
  constexpr int kR = kK4Chunks;
  const int sub = threadIdx.x & (L - 1);
  const int64_t stride = (int64_t)gridDim.x * (kK4Threads / L);
  const int n_tiles = kOne ? 1 : tiles;
  int64_t row = (int64_t)blockIdx.x * (kK4Threads / L) + threadIdx.x / L;
  int64_t start = 0, end = 0;
  if (row < n_rows) {
    start = __ldg(indptr + row);
    end = __ldg(indptr + row + 1);
  }
  // this lane's entry of the row's next chunk, loaded ahead of its use
  int col_next = 0;
  float v_next = 0.f;
  if (sub < end - start && end - start <= long_slice) {
    col_next = __ldg(indices + start + sub);
    v_next = __ldg(vals + start + sub);
  }
  for (;;) {
    if (!__any_sync(kK4All, row < n_rows)) break;
    const bool live = end > start && end - start <= long_slice;
    const int64_t next = row + stride;
    int64_t next_start = 0, next_end = 0;
    if (next < n_rows) {
      next_start = __ldg(indptr + next);
      next_end = __ldg(indptr + next + 1);
    }
    const bool next_live = next_end - next_start <= long_slice;
    const float* xr = x + (live ? row : 0) * d;
    float x0[kS][kP];  // x[r] when it is one tile
    if constexpr (kOne) k4_slots<kS, kP>(x0, xr, 0, d, L, sub, live);

    // the scores' numerators q: this lane's entry of each of the row's
    // last kR chunks in sc (its value in vr), the earlier chunks' in out;
    // s = q / ||x[r]|| / T once the row's norm is known (a positive
    // factor: the max commutes)
    float sc[kR], vr[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      sc[r] = -INFINITY;
      vr[r] = 0.f;
    }
    float mq = -INFINITY;
    int64_t chunks = 0;
    bool fetched = false;  // the next row's first chunk is on its way
    for (int64_t i = 0;; ++i) {
      const int64_t b = start + i * L;
      const bool more = live && b < end;
      if (!__any_sync(kK4All, more)) break;
      const int k = more ? (int)(end - b < L ? end - b : L) : 0;
      const int col = sub < k ? col_next : 0;
      const float v = sub < k ? v_next : 0.f;
      if (more && b + L < end) {
        col_next = __ldg(indices + b + L + sub);
        v_next = __ldg(vals + b + L + sub);
      } else if (more) {  // the row's last chunk: the next row's first
        fetched = true;
        col_next = 0;
        v_next = 0.f;
        if (next_live && sub < next_end - next_start) {
          col_next = __ldg(indices + next_start + sub);
          v_next = __ldg(vals + next_start + sub);
        }
      }
      const float mine = k4_chunk<kVec4, kS, kOne, K4Tile<kVec4, kS>::kB>(
          mq, col, v, k, x0, xr, x, d, L, sub, live, n_tiles);
      if (more) {  // team-uniform: keep the chunk, chunk i - kR goes to out
        if (i >= kR) out[b - (int64_t)kR * L + sub] = sc[0];
#pragma unroll
        for (int r = 0; r + 1 < kR; ++r) {
          sc[r] = sc[r + 1];
          vr[r] = vr[r + 1];
        }
        sc[kR - 1] = mine;
        vr[kR - 1] = v;
        chunks = i + 1;
      }
    }
    if (!fetched) {  // an empty row or a hub: the next row's first chunk
      col_next = 0;
      v_next = 0.f;
      if (next_live && sub < next_end - next_start) {
        col_next = __ldg(indices + next_start + sub);
        v_next = __ldg(vals + next_start + sub);
      }
    }
    const float dr =
        k4_row_norm<kVec4, kS, kOne>(x0, xr, d, L, sub, live, n_tiles);
    float m = mq / dr / temperature;
    if (!isfinite(m)) m = 0.f;
    const int64_t spilled = chunks > kR ? chunks - kR : 0;

    // p = exp(s - m) on the valid entries, and its sum over the row
    float sp = 0.f;
    for (int64_t ci = 0; ci < spilled; ++ci) {
      const int64_t e = start + ci * L + sub;
      const float p = __ldg(vals + e) != 0.f
                          ? expf(out[e] / dr / temperature - m) : 0.f;
      out[e] = p;
      sp += p;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float p = vr[r] != 0.f ? expf(sc[r] / dr / temperature - m) : 0.f;
      sc[r] = p;
      sp += p;
    }
    for (int off = L >> 1; off > 0; off >>= 1)
      sp += __shfl_xor_sync(kK4All, sp, off, L);
    const float dp = fmaxf(sp, 1e-10f);

    // a = p / max(sum p, 1e-10) * v, and its sum over the row
    float sa = 0.f;
    for (int64_t ci = 0; ci < spilled; ++ci) {
      const int64_t e = start + ci * L + sub;
      const float a = out[e] / dp * __ldg(vals + e);
      out[e] = a;
      sa += a;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float a = sc[r] / dp * vr[r];
      sc[r] = a;
      sa += a;
    }
    for (int off = L >> 1; off > 0; off >>= 1)
      sa += __shfl_xor_sync(kK4All, sa, off, L);
    const float da = fmaxf(sa, 1e-10f);

    for (int64_t ci = 0; ci < spilled; ++ci) {
      const int64_t e = start + ci * L + sub;
      out[e] = out[e] / da;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int64_t ci = chunks - kR + r;
      const int64_t e = start + ci * L + sub;
      if (ci >= 0 && e < end) out[e] = sc[r] / da;
    }
    row = next;
    start = next_start;
    end = next_end;
  }
}

// A team a slice of a hub row (kernels.HubPlan: slice w of its row's K
// takes the row's chunks of 32 entries w, w + K, ...): each entry's q
// into out (-inf where masked); then, over its own entries again, the
// slice's share of the row's softmax relative to its own max m_w:
// stats[4 w .. 4 w + 3] = (m_w, sum p, sum p v, ||x[r]||), with
// p = exp(s - m_w), the online softmax's (m, P, PV) state of the fused
// pass, so the row's sums need no pass over its entries.
template <bool kVec4, int kS, bool kOne>
__global__ void __launch_bounds__(kK4Threads)
    edge_attention_slices(const int64_t* __restrict__ indptr,
                          const int32_t* __restrict__ indices,
                          const float* __restrict__ vals,
                          const float* __restrict__ x, float* __restrict__ out,
                          int64_t d, float temperature, int L, int tiles,
                          const int32_t* __restrict__ item_rows,
                          const int64_t* __restrict__ item_starts,
                          const int32_t* __restrict__ item_cuts,
                          int64_t n_items, float* __restrict__ stats) {
  constexpr int kP = K4Tile<kVec4, kS>::kP;
  const int sub = threadIdx.x & (L - 1);
  const int64_t w =
      (int64_t)blockIdx.x * (kK4Threads / L) + threadIdx.x / L;
  const bool live = w < n_items;
  const int n_tiles = kOne ? 1 : tiles;
  int64_t row = 0, e0 = 0, stride = 32, end = 0;
  if (live) {
    row = __ldg(item_rows + w);
    e0 = __ldg(item_starts + w);
    stride = 32 * (int64_t)__ldg(item_cuts + w);
    end = __ldg(indptr + row + 1);
  }
  const float* xr = x + row * d;
  float x0[kS][kP];
  if constexpr (kOne) k4_slots<kS, kP>(x0, xr, 0, d, L, sub, live);
  const int per = 32 / L;  // segments of L entries in a chunk of 32
  float mq = -INFINITY;
  for (int64_t i = 0;; ++i) {
    const int64_t b = e0 + (i / per) * stride + (i % per) * L;
    const bool more = live && b < end;
    if (!__any_sync(kK4All, more)) break;
    const int k = more ? (int)(end - b < L ? end - b : L) : 0;
    int col = 0;
    float v = 0.f;
    if (sub < k) {
      col = __ldg(indices + b + sub);
      v = __ldg(vals + b + sub);
    }
    const float mine =
        k4_chunk<kVec4, kS, kOne, K4Tile<kVec4, kS>::kSliceB>(
            mq, col, v, k, x0, xr, x, d, L, sub, live, n_tiles);
    if (sub < k) out[b + sub] = mine;
  }
  const float dr =
      k4_row_norm<kVec4, kS, kOne>(x0, xr, d, L, sub, live, n_tiles);
  const float mw = mq / dr / temperature;  // -inf: no valid entry
  float sp = 0.f, spv = 0.f;
  for (int64_t i = 0; mw != -INFINITY; ++i) {  // this lane's own entries
    const int64_t e = e0 + (i / per) * stride + (i % per) * L + sub;
    if (e - sub >= end) break;
    if (e < end) {
      const float v = __ldg(vals + e);
      if (v != 0.f) {
        const float p = expf(out[e] / dr / temperature - mw);
        sp += p;
        spv += p * v;
      }
    }
  }
  for (int off = L >> 1; off > 0; off >>= 1) {
    sp += __shfl_xor_sync(kK4All, sp, off, L);
    spv += __shfl_xor_sync(kK4All, spv, off, L);
  }
  if (live && sub == 0) {
    stats[4 * w] = mw;
    stats[4 * w + 1] = sp;
    stats[4 * w + 2] = spv;
    stats[4 * w + 3] = dr;
  }
}

// A thread a hub row: its slices' states merged (m the largest m_w, each
// slice's sums scaled by exp(m_w - m)) into the row's m, max(sum p,
// 1e-10) and max(sum p v / that, 1e-10), written over its first slice's
// (m_w, sum p, sum p v); its ||x[r]|| stays.
__global__ void edge_attention_join(const int32_t* __restrict__ item_cuts,
                                    const int32_t* __restrict__ split,
                                    int64_t n_split,
                                    float* __restrict__ stats) {
  const int64_t h = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= n_split) return;
  const int64_t w0 = __ldg(split + h);
  const int cuts = __ldg(item_cuts + w0);
  float m = -INFINITY;
  for (int j = 0; j < cuts; ++j) m = fmaxf(m, stats[4 * (w0 + j)]);
  if (!isfinite(m)) m = 0.f;
  float sp = 0.f, spv = 0.f;
  for (int j = 0; j < cuts; ++j) {
    const float mw = stats[4 * (w0 + j)];
    if (mw == -INFINITY) continue;  // a slice with no valid entry
    const float f = expf(mw - m);
    sp += stats[4 * (w0 + j) + 1] * f;
    spv += stats[4 * (w0 + j) + 2] * f;
  }
  const float dp = fmaxf(sp, 1e-10f);
  stats[4 * w0] = m;
  stats[4 * w0 + 1] = dp;
  stats[4 * w0 + 2] = fmaxf(spv / dp, 1e-10f);
}

// A team a slice again: each entry's weight from its q and its row's
// (m, max(sum p, 1e-10), max(sum a, 1e-10)), as the rows' last passes
// compute it: exp(s - m) / dp * v / da.
__global__ void __launch_bounds__(kK4Threads)
    edge_attention_finish(const int64_t* __restrict__ indptr,
                          const float* __restrict__ vals,
                          float* __restrict__ out, float temperature, int L,
                          const int32_t* __restrict__ item_rows,
                          const int64_t* __restrict__ item_starts,
                          const int32_t* __restrict__ item_cuts,
                          int64_t n_items, const float* __restrict__ stats) {
  const int sub = threadIdx.x & (L - 1);
  const int64_t w =
      (int64_t)blockIdx.x * (kK4Threads / L) + threadIdx.x / L;
  if (w >= n_items) return;  // no shuffle in this kernel
  const int64_t row = __ldg(item_rows + w);
  const int64_t e0 = __ldg(item_starts + w);
  const int64_t stride = 32 * (int64_t)__ldg(item_cuts + w);
  const int64_t start = __ldg(indptr + row);
  const int64_t end = __ldg(indptr + row + 1);
  const int64_t w0 = w - (e0 - start) / 32;  // the row's first slice
  const float m = stats[4 * w0], dp = stats[4 * w0 + 1];
  const float da = stats[4 * w0 + 2], dr = stats[4 * w + 3];
  const int per = 32 / L;
  for (int64_t i = 0;; ++i) {
    const int64_t e = e0 + (i / per) * stride + (i % per) * L + sub;
    if (e - sub >= end) break;
    if (e < end) {
      const float v = __ldg(vals + e);
      out[e] = v != 0.f ? expf(out[e] / dr / temperature - m) / dp * v / da
                        : 0.f;
    }
  }
}

struct K4Args {
  const int64_t* indptr;
  const int32_t* indices;
  const float* vals;
  const float* x;
  float* out;
  int64_t n_rows, d;
  float temperature;
  int64_t long_slice;
  const int32_t* item_rows;
  const int64_t* item_starts;
  const int32_t* item_cuts;
  int64_t n_items;
  const int32_t* split;
  int64_t n_split;
  float* stats;
  cudaStream_t stream;
};

// The hubs' slices (their q and softmax states), the rows (a grid of as
// many blocks as the card holds at once, at most a row a team), then the
// hubs' joins and their slices' weights.
template <bool kVec4, int kS, bool kOne>
cudaError_t k4_launch(const K4Args& a, int L, int tiles) {
  const int64_t teams = kK4Threads / L;
  const unsigned item_blocks = (unsigned)((a.n_items + teams - 1) / teams);
  if (a.n_items > 0) {
    edge_attention_slices<kVec4, kS, kOne>
        <<<item_blocks, kK4Threads, 0, a.stream>>>(
            a.indptr, a.indices, a.vals, a.x, a.out, a.d, a.temperature, L,
            tiles, a.item_rows, a.item_starts, a.item_cuts, a.n_items,
            a.stats);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kernel = edge_attention_kernel<kVec4, kS, kOne>;
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        kK4Threads, 0);
  if (err != cudaSuccess) return err;
  const int64_t need = (a.n_rows + teams - 1) / teams;
  const int64_t held = (int64_t)sms * (resident > 0 ? resident : 1);
  kernel<<<(unsigned)(need < held ? need : held), kK4Threads, 0, a.stream>>>(
      a.indptr, a.indices, a.vals, a.x, a.out, a.n_rows, a.d, a.temperature,
      L, tiles, a.long_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 0) return err;
  edge_attention_join<<<(unsigned)((a.n_split + 127) / 128), 128, 0,
                        a.stream>>>(a.item_cuts, a.split, a.n_split,
                                    a.stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  edge_attention_finish<<<item_blocks, kK4Threads, 0, a.stream>>>(
      a.indptr, a.vals, a.out, a.temperature, L, a.item_rows, a.item_starts,
      a.item_cuts, a.n_items, a.stats);
  return cudaGetLastError();
}

// K4's layout of rows of d columns: a team of L lanes, `slots` slots a
// lane in each of `tiles` column tiles (one tile up to K4Max's width).
template <bool kVec4>
cudaError_t k4_dispatch(const K4Args& a) {
  constexpr int kMax = K4Max<kVec4>::kS;
  const int64_t groups = kVec4 ? a.d / 4 : a.d;
  const int L = groups >= 32 ? 32 : row_team::pow2_at_least(groups);
  const int64_t need = (groups + L - 1) / L;
  if (need > kMax)
    return k4_launch<kVec4, kMax, false>(a, L,
                                         (int)((need + kMax - 1) / kMax));
  // the fewest slots that hold the row among those compiled: a slot past
  // the row holds registers and loads nothing
#define K4_CASE(S) \
  if (need <= S) return k4_launch<kVec4, S, true>(a, L, 1);
  K4_CASE(1)
  K4_CASE(2)
  if constexpr (kVec4) {
    K4_CASE(3)
    K4_CASE(4)
    K4_CASE(6)
    K4_CASE(8)
    K4_CASE(9)
    K4_CASE(12)
    K4_CASE(16)
  } else {
    K4_CASE(4)
    K4_CASE(8)
    K4_CASE(16)
    K4_CASE(32)
  }
#undef K4_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches K4 on `stream` and returns the first cudaGetLastError() that is
// not 0.  x is the raw float32 (N, D) state (K4 normalises its rows
// itself), out a new float32 (nnz).  `vec4` requires d % 4 == 0 and x
// 16-byte aligned (checked by the Python wrapper).  Rows of more than
// `long_slice` entries are taken by the n_items slices of kernels.HubPlan
// (split: the first slice of each of the n_split hub rows), which need
// 4 n_items float32 in `stats`; pass long_slice = INT64_MAX and no items
// to walk every row with its own team.
extern "C" int edge_attention_launch(
    const int64_t* indptr, const int32_t* indices, const float* vals,
    const float* x, float* out, int64_t n_rows, int64_t d, float temperature,
    int vec4, int64_t long_slice, const int32_t* item_rows,
    const int64_t* item_starts, const int32_t* item_cuts, int64_t n_items,
    const int32_t* split, int64_t n_split, float* stats, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  const K4Args a{indptr, indices, vals, x, out, n_rows, d, temperature,
                 long_slice, item_rows, item_starts, item_cuts, n_items,
                 split, n_split, stats, static_cast<cudaStream_t>(stream)};
  return (int)(vec4 ? k4_dispatch<true>(a) : k4_dispatch<false>(a));
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
