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
// The common-neighbour test and the backtrack lookup are lower-bound binary
// searches in the (row, col)-sorted CSR row that stop on lo < hi (a hub row
// may hold tens of thousands of entries; the JAX engine's fixed step count
// was a TPU artefact).
//
// Bound on the card: bytes, in 32-byte sectors.  Per hop a walk reads deg,
// indptr, wmax and wsum of cur and the backtrack search in cur's row; per
// round cols and vals of the proposal and the search in prev's row.  All
// reads are random and dependent, so the kernel is latency-bound.
//
// Design: one thread per walk runs the whole walk, with the rejection
// rounds as a loop per hop (walk2_hop.cuh, shared with K18).  The TPU engine compacted the rejecting lanes
// with three top_k stages because XLA pays the full batch width per round;
// a thread retires on its own, so that machinery has no counterpart here.
// A warp waits on its slowest lane's rounds each hop.

#include <cstdint>

#include <cuda_runtime.h>

#include "walk2_hop.cuh"

namespace {

__global__ void walk_p_q_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols,
    const float* __restrict__ vals, const int32_t* __restrict__ deg,
    const float* __restrict__ wmax, const float* __restrict__ wsum,
    const int32_t* __restrict__ starts, int32_t* __restrict__ walks,
    int64_t batch, int walk_length, int64_t base, uint32_t k0, uint32_t k1,
    int32_t n, float inv_p, float inv_q, int tries) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint64_t g = (uint64_t)(base + b);
  int32_t* row = walks + b * walk_length;
  int32_t prev = n;
  int32_t cur = __ldg(starts + b);
  row[0] = cur;
  for (int h = 0; h + 1 < walk_length; ++h) {
    int32_t nxt = n;
    if (cur >= 0 && cur < n) {
      const bool first = !(prev >= 0 && prev < n);
      const walk2::Head t = walk2::hop_head(indptr, cols, vals, deg, wmax,
                                            wsum, cur, prev, first, inv_p,
                                            inv_q);
      nxt = walk2::hop(indptr, cols, vals, deg, t, prev, prev, first, g, h,
                       k0, k1, n, inv_q, tries);
    }
    prev = cur;
    cur = nxt;
    row[h + 1] = cur;
  }
}

}  // namespace

// Launches K12 on `stream` and returns cudaGetLastError().  `walks` is
// (batch, walk_length) int32, row-major.  The tables are validated once
// when they are built (ops/walk.py WalkTables2): indptr[i] + deg[i] <=
// len(cols), every column below n, each row's columns ascending.
extern "C" int walk_p_q_launch(const int32_t* indptr, const int32_t* cols,
                               const float* vals, const int32_t* deg,
                               const float* wmax, const float* wsum,
                               const int32_t* starts, int32_t* walks,
                               int64_t batch, int walk_length, int64_t base,
                               uint32_t k0, uint32_t k1, int32_t n,
                               float inv_p, float inv_q, int tries,
                               void* stream) {
  if (batch > 0 && walk_length > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 128;
    const dim3 grid((unsigned)((batch + threads - 1) / threads));
    walk_p_q_kernel<<<grid, threads, 0, s>>>(
        indptr, cols, vals, deg, wmax, wsum, starts, walks, batch,
        walk_length, base, k0, k1, n, inv_p, inv_q, tries);
  }
  return (int)cudaGetLastError();
}
