// K12: second-order (Node2Vec p/q) random walks, hand-written for Hopper
// (sm_90a).
//
// Replaces the JAX package's second-order walk engine
// cleora_tpu/algorithms.py _device_walk2_jit (:1768-1963).  Uniform first
// hop, then the next hop from cur with probability proportional to
// w(cur->x) * alpha, where alpha = 1/p for x == prev, 1 for a common
// neighbour of prev and cur, 1/q otherwise.  Sampled by composition and
// rejection, per hop:
//
//   w_bt = vals[pos(prev in row cur)] * inv_p     (0 when prev is absent)
//   m2   = max(1, inv_q)
//   env  = w_bt + (float(d) * wmax[cur]) * m2
//   pi   = w_bt / max(env, 1e-30)
//   dead = wsum[cur] * m2 + w_bt < 1e-15
//
// and then, for round r = 0 .. tries-1: with probability pi take prev;
// otherwise propose x = cols[indptr[cur] + min(int(u1 * float(d)), d-1)] and
// accept it with (w * alpha2) / max(wmax[cur] * m2, 1e-30), alpha2 = 0 for
// x == prev.  The first hop (no prev yet) takes the round-0 proposal.  After
// `tries` rounds the last uniform proposal is taken.  A lane whose current
// node is the sentinel n (a pad lane, or a walk that stopped) or has degree
// 0, or whose row is dead, writes n and stays there (:1927-1928).
//
// Uniforms: round r of hop h (0-based, h = 0 .. L-2) of the walk whose
// global index is g = base + b takes the first three output words x0, x1,
// x2 of Philox4x32-10 (Salmon et al., SC'11; Random123) with counter
//
//   (g & 0xffffffff, g >> 32, h, r + 1)
//
// and key (seed & 0xffffffff, seed >> 32), each as u = (x >> 8) * 2^-24:
// u0 is the backtrack test (u0 < pi), u1 the proposal, u2 the acceptance
// test (u2 < p_acc).  K8 draws at (g lo, g hi, h, 0), so the fourth word,
// never 0 here, keeps the two streams apart.  The walks depend on neither the
// batch size nor the device; ops/walk.py's walk_p_q_plain reproduces them
// bit for bit.  Every float operation is written with a round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn), which nvcc never contracts
// into an FMA, in the order of the formulas above.
//
// Bound on the card: bytes, in 32-byte sectors.  Per hop a walk reads the
// head of cur (its first entry, degree, wmax and wsum) and the backtrack
// lookup in cur's row; per round cols and vals of the proposal and the
// lookup in prev's row.  All reads are random and dependent, so the kernel
// is latency-bound: its time follows the chain of dependent loads a hop.
//
// Design (walk2_hop.cuh's record and window form).  The chain of a hop is
// cut to three dependent loads:
//   * one 16-byte head record a row (ops/walk.py WalkTables2.head,
//     kernels.walk_head) where four arrays took four sectors;
//   * cur's row is loaded as one window (up to kWindow entries from its
//     first entry rounded down to 4, in 16-byte loads that are all in
//     flight at once) and prev is found in it by a scan of registers, where
//     lower_bound took about four dependent steps at the corpus's mean
//     degree of about 11; a longer row is narrowed by lower_bound's steps
//     until a window holds the rest;
//   * that window is kept: it is prev's row at the next hop, so the
//     common-neighbour test of every rejection round reads no memory for
//     a row that fits (else row_find in prev's row).
// The position found is lower_bound's, and every float operation is the
// round-to-nearest intrinsic of walk2_hop.cuh's hop in its order, so the
// walks are bitwise the four-array form's (K18 keeps that form over its
// slices) and the plain version's.  A walk's nodes are buffered in
// registers and stored kGroup at a time (8 nodes: one 32-byte sector, two
// 16-byte stores), not one 4-byte store a hop at the walk row's stride.
// scripts/torch_k5_k12_probe.py measured the shape on an H100 (131,072
// walks of 80): one lane a walk (the window's eight 16-byte loads from one
// thread) beat teams of 2 and 4 lanes that split the loads and reduced by
// shuffles (more warps, fewer walks in flight); a window of 32 entries
// beat 16 and 8; a store a hop cost twice the buffered stores.  The TPU
// engine compacted the rejecting lanes with three top_k stages because XLA
// pays the full batch width per round; a thread retires on its own, so
// that machinery has no counterpart here.  A warp waits on the slowest of
// its 32 walks each hop.

#include <cstdint>

#include <cuda_runtime.h>

#include "walk2_hop.cuh"

namespace {

constexpr int kThreads = 512;  // a block
constexpr int kGroup = 8;      // nodes a walk stores at a time

// A walk's current group of kGroup nodes, in registers.
struct Nodes {
  int32_t v[kGroup];
};

__device__ __forceinline__ void put(Nodes& buf, int pos, int32_t node) {
  const int slot = pos % kGroup;
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    if (i == slot) buf.v[i] = node;
}

// Stores the group that ends at `pos` (its last node); a whole group of a
// row whose start is 16-byte aligned as vectors.
__device__ __forceinline__ void flush(const Nodes& buf, int32_t* row,
                                      int pos, bool vec) {
  const int start = pos / kGroup * kGroup;
  int32_t* at = row + start;
  if constexpr (kGroup % 4 == 0) {
    if (vec && pos - start == kGroup - 1) {
#pragma unroll
      for (int i = 0; i < kGroup; i += 4)
        *reinterpret_cast<int4*>(at + i) =
            make_int4(buf.v[i], buf.v[i + 1], buf.v[i + 2], buf.v[i + 3]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    if (start + i <= pos) at[i] = buf.v[i];
}

__global__ void __launch_bounds__(kThreads) walk_p_q_kernel(
    const int4* __restrict__ head, const int32_t* __restrict__ cols,
    const float* __restrict__ vals, const int32_t* __restrict__ starts,
    int32_t* __restrict__ walks, int64_t batch, int walk_length,
    int64_t base, uint32_t k0, uint32_t k1, int32_t n, float inv_p,
    float inv_q, int tries) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const uint64_t g = (uint64_t)(base + b);
  int32_t* row = walks + b * walk_length;
  const bool vec = (walk_length & 3) == 0;
  Nodes buf;
  int32_t prev = n;
  int32_t cur = __ldg(starts + b);
  put(buf, 0, cur);
  if (walk_length == 1) flush(buf, row, 0, vec);
  // prev's row: [plo, phi), and its window when it holds the row
  int32_t plo = 0, phi = 0;
  bool pfit = false;
  walk2::Window pw{};
  for (int h = 0; h + 1 < walk_length; ++h) {
    int32_t nxt = n, lo = 0, hi = 0;
    bool fit = false;
    walk2::Window cw{};
    if (cur >= 0 && cur < n) {
      const bool first = !(prev >= 0 && prev < n);
      const int4 rec = __ldg(head + cur);
      const int32_t d = rec.y;
      lo = rec.x;
      hi = lo + d;
      float w_bt = 0.0f;
      bool dead = true;
      if (d > 0) {
        fit = walk2::window_holds(lo, hi);
        if (fit) cw = walk2::load_window(cols, lo, hi);
        if (!first) {
          const walk2::Found f = fit ? walk2::window_find(cw, lo, hi, prev)
                                     : walk2::row_find(cols, lo, hi, prev);
          if (f.hit) w_bt = __fmul_rn(__ldg(vals + f.pos), inv_p);
        }
        dead = __fadd_rn(__fmul_rn(__int_as_float(rec.w), fmaxf(1.0f, inv_q)),
                         w_bt) < 1e-15f;
      }
      if (!dead) {
        const walk2::Terms s =
            walk2::hop_terms(d, __int_as_float(rec.z), w_bt, inv_q);
        for (int r = 0; r < tries; ++r) {
          const walk2::Uniforms u = walk2::round_uniforms(g, h, r, k0, k1);
          if (!first && u.u0 < s.pi) {
            nxt = prev;
            break;
          }
          const int32_t e = walk2::proposal(lo, d, u.u1);
          const int32_t cand = __ldg(cols + e);
          if (first || r == tries - 1) {
            nxt = cand;
            break;
          }
          float alpha = 0.0f;
          if (cand != prev) {
            const walk2::Found m =
                pfit ? walk2::window_find(pw, plo, phi, cand)
                     : walk2::row_find(cols, plo, phi, cand);
            alpha = m.hit ? 1.0f : inv_q;
          }
          if (walk2::accepts(u.u2, __ldg(vals + e), alpha, s.cap)) {
            nxt = cand;
            break;
          }
        }
      }
    }
    prev = cur;
    cur = nxt;
    plo = lo;
    phi = hi;
    pfit = fit;
    pw = cw;
    put(buf, h + 1, cur);
    if ((h + 2) % kGroup == 0 || h + 2 == walk_length)
      flush(buf, row, h + 1, vec);
  }
}

}  // namespace

// Launches K12 on `stream` and returns cudaGetLastError().  `head` is the
// (n, 4) int32 head records, `cols` 16-byte aligned, `walks` (batch,
// walk_length) int32, row-major.  The tables are validated once when they
// are built (ops/walk.py WalkTables2): first entry + degree <= len(cols),
// every column below n, each row's columns ascending.
extern "C" int walk_p_q_launch(const int32_t* head, const int32_t* cols,
                               const float* vals, const int32_t* starts,
                               int32_t* walks, int64_t batch,
                               int walk_length, int64_t base, uint32_t k0,
                               uint32_t k1, int32_t n, float inv_p,
                               float inv_q, int tries, void* stream) {
  if (batch > 0 && walk_length > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((unsigned)((batch + kThreads - 1) / kThreads));
    walk_p_q_kernel<<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const int4*>(head), cols, vals, starts, walks, batch,
        walk_length, base, k0, k1, n, inv_p, inv_q, tries);
  }
  return (int)cudaGetLastError();
}
