// K8: first-order uniform random walks, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's walk engine cleora_tpu/algorithms.py
// _device_walk_jit (:1122-1155), one lax.scan step per hop:
//
//   walks[b, 0] = starts[b]
//   walks[b, h] = cols[indptr[cur] + min(int(u * float(deg[cur])), deg[cur]-1)]
//
// for h = 1 .. L-1, cur = walks[b, h-1].  A lane whose current node is the
// sentinel n (a pad lane, or a walk that reached a dead end) or has degree 0
// writes n and stays there (:1137-1148).
//
// The uniform u of hop h (0-based, h = 0 .. L-2) of the walk whose global
// index is g = base + b comes from Philox4x32-10 (Salmon et al., SC'11;
// Random123) with counter (g & 0xffffffff, g >> 32, h, 0) and key
// (seed & 0xffffffff, seed >> 32): u = (x0 >> 8) * 2^-24 of the first output
// word.  The walks therefore depend on neither the batch size nor the
// device, and ops/walk.py's plain version reproduces them bit for bit
// (jax.random streams cannot be reproduced, so the JAX package is matched in
// distribution only).
//
// Bound on the card: bytes, in 32-byte sectors.  Each live hop of each walk
// reads its row's record (indptr[cur], deg[cur]) and, when it moves,
// cols[...]: random reads of a whole sector each, two a moving hop (the
// three-array form read three: deg, indptr, cols); the walk matrix is
// written once.
//
// Design: one thread per walk runs the whole walk in registers in one
// launch (the TPU ran one dispatch per batch with a scan over the hops).
// The chain of a hop is cut to two dependent loads, and the stores to
// whole sectors:
//   * one 8-byte record a row, (indptr[i], deg[i]) as an int2 (ops/walk.py
//     WalkTables.record, kernels.walk_record), where two arrays took two
//     dependent sectors: one load gives the degree test and the row start;
//   * the Philox draw of hop h + 1 depends on (g, h + 1) alone, so it is
//     computed while hop h's record and column loads are in flight;
//   * a walk's nodes are buffered in registers and stored kGroup at a time
//     (16 nodes: two 32-byte sectors, four 16-byte stores where the row is
//     16-byte aligned), with a shorter last group, not one 4-byte store a
//     hop at the walk row's stride.
// The draw and the hop are walk_hop.cuh's (philox_x0, pick), which K17
// runs too: one round-to-nearest product and a truncation, which the plain
// version repeats exactly.  A thread runs kWalks = 2 walks, interleaved hop
// by hop.  scripts/torch_k8_k13_probe.py measured the shape on an H100
// (131,072 walks of 80): stores of 16 nodes beat 8 (0.301 against 0.350
// ms), 32 (0.313) and 1 (0.702, a store a hop); 2 walks a thread beat 1 by
// about 2 %; blocks of 64-512 threads were within 1 %.

#include <cstdint>

#include <cuda_runtime.h>

#include "walk_hop.cuh"

namespace {

constexpr int kThreads = 128;  // a block
constexpr int kGroup = 16;     // nodes a walk stores at a time
constexpr int kWalks = 2;      // walks a thread, interleaved

// Stores the first `count` nodes of `v` at `at`; a whole group of a row
// whose start is 16-byte aligned as vectors.
__device__ __forceinline__ void flush(const int32_t (&v)[kGroup],
                                      int32_t* at, int count, bool vec) {
  if constexpr (kGroup % 4 == 0) {
    if (vec && count == kGroup) {
#pragma unroll
      for (int i = 0; i < kGroup; i += 4)
        *reinterpret_cast<int4*>(at + i) =
            make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    if (i < count) at[i] = v[i];
}

__global__ void __launch_bounds__(kThreads) walk_uniform_kernel(
    const int2* __restrict__ record, const int32_t* __restrict__ cols,
    const int32_t* __restrict__ starts, int32_t* __restrict__ walks,
    int64_t batch, int walk_length, int64_t base, uint32_t k0, uint32_t k1,
    int32_t n) {
  const int64_t first = (int64_t)blockIdx.x * (kThreads * kWalks) +
                        threadIdx.x;
  if (first >= batch) return;
  const bool vec = (walk_length & 3) == 0;
  int64_t b[kWalks];
  bool on[kWalks];
  uint32_t g0[kWalks], g1[kWalks], bits[kWalks];
  int32_t cur[kWalks], v[kWalks][kGroup];
#pragma unroll
  for (int w = 0; w < kWalks; ++w) {
    b[w] = first + (int64_t)w * kThreads;
    on[w] = b[w] < batch;
    const uint64_t g = (uint64_t)(base + b[w]);
    g0[w] = (uint32_t)g;
    g1[w] = (uint32_t)(g >> 32);
    cur[w] = on[w] ? __ldg(starts + b[w]) : n;
    bits[w] = walk_hop::philox_x0(g0[w], g1[w], 0u, k0, k1);
  }
  for (int p0 = 0; p0 < walk_length; p0 += kGroup) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int p = p0 + i;  // the node hop p - 1 resolves
      if (p > 0 && p < walk_length) {
        int2 rec[kWalks];
#pragma unroll
        for (int w = 0; w < kWalks; ++w)
          rec[w] = (cur[w] >= 0 && cur[w] < n) ? __ldg(record + cur[w])
                                               : make_int2(0, 0);
        uint32_t ahead[kWalks];  // hop p's draw, while the loads fly
#pragma unroll
        for (int w = 0; w < kWalks; ++w)
          ahead[w] = walk_hop::philox_x0(g0[w], g1[w], (uint32_t)p, k0, k1);
#pragma unroll
        for (int w = 0; w < kWalks; ++w) {
          int32_t nxt = n;
          if (rec[w].y > 0)
            nxt = __ldg(cols + rec[w].x + walk_hop::pick(bits[w], rec[w].y));
          cur[w] = nxt;
          bits[w] = ahead[w];
        }
      }
#pragma unroll
      for (int w = 0; w < kWalks; ++w) v[w][i] = cur[w];
    }
    const int count = walk_length - p0 < kGroup ? walk_length - p0 : kGroup;
#pragma unroll
    for (int w = 0; w < kWalks; ++w)
      if (on[w]) flush(v[w], walks + b[w] * walk_length + p0, count, vec);
  }
}

}  // namespace

// Launches K8 on `stream` and returns cudaGetLastError().  `record` is the
// (n, 2) int32 records (indptr[i], deg[i]), 8-byte aligned; `walks` is
// (batch, walk_length) int32, row-major.  The tables are validated once
// when they are built (ops/walk.py WalkTables): indptr[i] + deg[i] <=
// len(cols) and every column below n.
extern "C" int walk_uniform_launch(const int32_t* record,
                                   const int32_t* cols,
                                   const int32_t* starts, int32_t* walks,
                                   int64_t batch, int walk_length,
                                   int64_t base, uint32_t k0, uint32_t k1,
                                   int32_t n, void* stream) {
  if (batch > 0 && walk_length > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int per_block = kThreads * kWalks;
    const dim3 grid((unsigned)((batch + per_block - 1) / per_block));
    walk_uniform_kernel<<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const int2*>(record), cols, starts, walks, batch,
        walk_length, base, k0, k1, n);
  }
  return (int)cudaGetLastError();
}
