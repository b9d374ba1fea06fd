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
// Bound on the card: bytes, in 32-byte sectors.  Each hop of each walk makes
// three dependent random reads (indptr[cur], deg[cur], cols[...]), each of
// which moves a whole 32-byte sector, and writes one int32.
//
// Design: one thread per walk runs the whole walk in registers in one
// launch (the TPU ran one dispatch per batch with a scan over the hops).
// Philox needs only 32-bit multiplies (__umulhi) and xors.  The hop itself
// is walk_hop.cuh's, which K17 runs too: one round-to-nearest product and a
// truncation, which the plain version repeats exactly.

#include <cstdint>

#include <cuda_runtime.h>

#include "walk_hop.cuh"

namespace {

__global__ void walk_uniform_kernel(const int32_t* __restrict__ indptr,
                                    const int32_t* __restrict__ cols,
                                    const int32_t* __restrict__ deg,
                                    const int32_t* __restrict__ starts,
                                    int32_t* __restrict__ walks, int64_t batch,
                                    int walk_length, int64_t base,
                                    uint32_t k0, uint32_t k1, int32_t n) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint64_t g = (uint64_t)(base + b);
  const uint32_t g0 = (uint32_t)g, g1 = (uint32_t)(g >> 32);
  int32_t* row = walks + b * walk_length;
  int32_t cur = __ldg(starts + b);
  row[0] = cur;
  for (int h = 0; h + 1 < walk_length; ++h) {
    int32_t nxt = n;
    if (cur >= 0 && cur < n) {
      const int32_t d = __ldg(deg + cur);
      if (d > 0)
        nxt = walk_hop::next(indptr, cols, cur, d, g0, g1, (uint32_t)h, k0,
                             k1);
    }
    cur = nxt;
    row[h + 1] = cur;
  }
}

}  // namespace

// Launches K8 on `stream` and returns cudaGetLastError().  `walks` is
// (batch, walk_length) int32, row-major.  The tables are validated once
// when they are built (ops/walk.py WalkTables): indptr[i] + deg[i] <=
// len(cols) and every column below n.
extern "C" int walk_uniform_launch(const int32_t* indptr, const int32_t* cols,
                                   const int32_t* deg, const int32_t* starts,
                                   int32_t* walks, int64_t batch,
                                   int walk_length, int64_t base, uint32_t k0,
                                   uint32_t k1, int32_t n, void* stream) {
  if (batch > 0 && walk_length > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 128;
    const dim3 grid((unsigned)((batch + threads - 1) / threads));
    walk_uniform_kernel<<<grid, threads, 0, s>>>(indptr, cols, deg, starts,
                                                 walks, batch, walk_length,
                                                 base, k0, k1, n);
  }
  return (int)cudaGetLastError();
}
