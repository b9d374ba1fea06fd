// K15: the GCN's hidden-layer epilogue, ReLU with inverted dropout, and its
// gradient, hand-written for Hopper (sm_90a).
//
// Replaces the hidden-layer tail of the JAX package's _gcn_forward
// (cleora_tpu/classify.py:131-138) and its part of the jax.grad backward in
// _gcn_jits (:149-161):
//
//   forward:  h[e]  = keep[e] && z[e] > 0 ? z[e] / q  : 0
//   backward: dz[e] = keep[e] && z[e] > 0 ? dh[e] / q : 0
//
// over the flat row-major elements e of z, with q = 1 - p rounded to float32
// by the caller and keep[e] = (u[e] >= p).  u[e] is word e % 4 of
// Philox4x32-10 (Salmon et al., SC'11) at counter (e / 4 low word, e / 4 high
// word, epoch, layer) under the key (seed low word, seed high word), as
// (x >> 8) * 2^-24.  p = 0 draws nothing.  The backward recomputes the mask
// from its counter, so no mask is stored.  The division is a true
// round-to-nearest division (jnp.where(keep, H / (1 - dropout), 0.0)), and
// ops/gcn.py's plain versions reproduce both directions bit for bit.
//
// Bound on the card: bytes.  The forward reads z and writes h (8 B per
// element), the backward reads z and dh and writes dz (12 B per element);
// Philox costs about 60 integer operations per 4 elements, below the bytes'
// time at the card's integer rate.
//
// Design: XLA fuses the ReLU, the Bernoulli draw and the select into the
// program around them; here one thread takes the 4 elements of one Philox
// call, so each call's four words are all used, and consecutive threads
// touch consecutive 16-byte spans.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

// Philox4x32-10 at counter (c0, c1, c2, c3) under the key (k0, k1).
__device__ __forceinline__ void philox4(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0, uint32_t k1,
                                        uint32_t x[4]) {
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
  x[0] = c0;
  x[1] = c1;
  x[2] = c2;
  x[3] = c3;
}

// src is z in the forward and dh in the backward; the kept value is
// src[e] / q wherever z[e] > 0 and the draw keeps e.
__global__ void relu_dropout_kernel(const float* __restrict__ z,
                                    const float* __restrict__ src,
                                    float* __restrict__ out, int64_t numel,
                                    float p, float q, uint32_t k0,
                                    uint32_t k1, uint32_t epoch,
                                    uint32_t layer) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t first = g * 4;
  if (first >= numel) return;
  uint32_t x[4] = {0u, 0u, 0u, 0u};
  if (p != 0.f) {
    philox4((uint32_t)g, (uint32_t)((uint64_t)g >> 32), epoch, layer, k0, k1,
            x);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t e = first + j;
    if (e < numel) {
      bool keep = __ldg(z + e) > 0.f;
      if (p != 0.f) {
        const float u = __uint2float_rn(x[j] >> 8) * 5.9604644775390625e-08f;
        keep = keep && u >= p;
      }
      out[e] = keep ? __fdiv_rn(__ldg(src + e), q) : 0.f;
    }
  }
}

cudaError_t launch(const float* z, const float* src, float* out,
                   int64_t numel, float p, float q, uint32_t k0, uint32_t k1,
                   uint32_t epoch, uint32_t layer, void* stream) {
  if (numel > 0) {
    const int threads = 256;
    const int64_t groups = (numel + 3) / 4;
    const dim3 grid((unsigned)((groups + threads - 1) / threads));
    relu_dropout_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        z, src, out, numel, p, q, k0, k1, epoch, layer);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches K15's forward on `stream` (h from z) and returns
// cudaGetLastError().
extern "C" int relu_dropout_launch(const float* z, float* h, int64_t numel,
                                   float p, float q, uint32_t k0, uint32_t k1,
                                   uint32_t epoch, uint32_t layer,
                                   void* stream) {
  return (int)launch(z, z, h, numel, p, q, k0, k1, epoch, layer, stream);
}

// Launches K15's backward on `stream` (dz from z and dh) and returns
// cudaGetLastError().
extern "C" int relu_dropout_backward_launch(const float* z, const float* dh,
                                            float* dz, int64_t numel, float p,
                                            float q, uint32_t k0, uint32_t k1,
                                            uint32_t epoch, uint32_t layer,
                                            void* stream) {
  return (int)launch(z, dh, dz, numel, p, q, k0, k1, epoch, layer, stream);
}
