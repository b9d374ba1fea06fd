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
// Philox needs only 32-bit multiplies (__umulhi) and xors.  The float
// arithmetic is one round-to-nearest product and a truncation, which the
// plain version repeats exactly.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

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
      if (d > 0) {
        const uint32_t bits = philox_x0(g0, g1, (uint32_t)h, k0, k1);
        const float u = __uint2float_rn(bits >> 8) * 5.9604644775390625e-08f;
        int32_t t = (int32_t)__fmul_rn(u, __int2float_rn(d));
        if (t > d - 1) t = d - 1;
        nxt = __ldg(cols + __ldg(indptr + cur) + t);
      }
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
