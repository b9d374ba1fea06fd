// K15: the GCN's hidden-layer epilogue, ReLU with inverted dropout, and its
// gradient, hand-written for Hopper (sm_90a).
//
// Replaces the hidden-layer tail of the JAX package's _gcn_forward
// (cleora_tpu/classify.py:131-138) and its part of the jax.grad backward in
// _gcn_jits (:149-161):
//
//   forward:  bit[e] = keep[e] && z[e] > 0
//             h[e]   = bit[e] ? z[e] / q : 0
//   backward: dz[e]  = bit[e] ? dh[e] / q : 0
//
// over the flat row-major elements e of z, with q = 1 - p rounded to float32
// by the caller and keep[e] = (u[e] >= p).  u[e] is word e % 4 of
// Philox4x32-10 (Salmon et al., SC'11) at counter (e / 4 low word, e / 4 high
// word, epoch, layer) under the key (seed low word, seed high word), as
// (x >> 8) * 2^-24.  p = 0 draws nothing.  The forward writes the bits as a
// packed mask, bit e % 32 of int32 word e / 32, and the backward reads them
// (and draws nothing), so the layer keeps 1 bit an element for its backward
// in place of z.  The division is a true round-to-nearest division
// (jnp.where(keep, H / (1 - dropout), 0.0)); ops/gcn.py's plain versions
// reproduce h, the mask and dz bit for bit.
//
// Bound on the card: bytes.  The forward reads z and writes h and the mask
// (8.125 B an element), the backward reads the mask and dh and writes dz
// (8.125 B an element).  Philox costs about 70 integer instructions a group
// of 4 elements, below the bytes' time at the card's integer rate.
//
// Design: a group is the 4 elements of one Philox call, one 16-byte vector
// load and store.  A warp takes a tile of 32 x kUnroll consecutive groups,
// lane l groups l, l + 32, ..., so each load and store instruction of the
// warp covers 512 contiguous bytes and a thread has kUnroll loads (and
// Philox calls) in flight; the warps walk the tiles in a grid-stride loop.
// In the forward the 4 bits of a group are a nibble, and three xor-shuffles
// gather the nibbles of 8 neighbouring lanes into one mask word.  A tail
// group (numel % 4 != 0) takes scalar loads.  z, h, dh and dz must be
// 16-byte aligned (the wrapper checks).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                // groups a lane holds at once
constexpr int kTileGroups = 32 * kUnroll;  // groups a warp takes at once
constexpr int kBlocksPerSm = 8;

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

// Group g's 4 elements (0 past numel).
__device__ __forceinline__ float4 load_group(const float* __restrict__ src,
                                             int64_t g, int64_t numel) {
  const int64_t e = g * 4;
  if (e + 4 <= numel)
    return __ldg(reinterpret_cast<const float4*>(src) + g);
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < 4 && e + j < numel; ++j) v[j] = __ldg(src + e + j);
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_group(float* __restrict__ dst,
                                            int64_t g, int64_t numel,
                                            float4 v) {
  const int64_t e = g * 4;
  if (e + 4 <= numel) {
    reinterpret_cast<float4*>(dst)[g] = v;
    return;
  }
  const float w[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < 4 && e + j < numel; ++j) dst[e + j] = w[j];
}

__device__ __forceinline__ float kept(bool bit, float v, float q) {
  return bit ? __fdiv_rn(v, q) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
    forward_kernel(const float* __restrict__ z, float* __restrict__ h,
                   int32_t* __restrict__ mask, int64_t numel, float p,
                   float q, uint32_t k0, uint32_t k1, uint32_t epoch,
                   uint32_t layer) {
  const int64_t groups = (numel + 3) / 4;
  const int64_t tiles = (groups + kTileGroups - 1) / kTileGroups;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t tile = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
       tile < tiles; tile += warps) {  // warp-uniform
    const int64_t g0 = tile * kTileGroups + lane;
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + u * 32;
      v[u] = g < groups ? load_group(z, g, numel)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + u * 32;
      uint32_t x[4] = {0u, 0u, 0u, 0u};
      if (p != 0.f)
        philox4((uint32_t)g, (uint32_t)((uint64_t)g >> 32), epoch, layer, k0,
                k1, x);
      const float in[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      float out[4];
      uint32_t nibble = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool bit = in[j] > 0.f;
        if (p != 0.f) {
          const float r = __uint2float_rn(x[j] >> 8) * 5.9604644775390625e-08f;
          bit = bit && r >= p;
        }
        out[j] = kept(bit, in[j], q);
        nibble |= (uint32_t)bit << j;
      }
      if (g < groups)
        store_group(h, g, numel, make_float4(out[0], out[1], out[2], out[3]));
      // lanes 8k .. 8k + 7 hold word (g0 + u * 32) / 8 + k
      uint32_t word = nibble << (4 * (lane & 7));
      word |= __shfl_xor_sync(kAll, word, 1);
      word |= __shfl_xor_sync(kAll, word, 2);
      word |= __shfl_xor_sync(kAll, word, 4);
      if ((lane & 7) == 0 && g < groups) mask[g >> 3] = (int32_t)word;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    backward_kernel(const int32_t* __restrict__ mask,
                    const float* __restrict__ dh, float* __restrict__ dz,
                    int64_t numel, float q) {
  const int64_t groups = (numel + 3) / 4;
  const int64_t tiles = (groups + kTileGroups - 1) / kTileGroups;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t tile = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
       tile < tiles; tile += warps) {
    const int64_t g0 = tile * kTileGroups + lane;
    float4 v[kUnroll];
    uint32_t nib[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + u * 32;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      nib[u] = 0;
      if (g < groups) {
        v[u] = load_group(dh, g, numel);
        nib[u] = ((uint32_t)__ldg(mask + (g >> 3)) >> (4 * (g & 7))) & 15u;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + u * 32;
      if (g < groups)
        store_group(dz, g, numel,
                    make_float4(kept(nib[u] & 1u, v[u].x, q),
                                kept(nib[u] & 2u, v[u].y, q),
                                kept(nib[u] & 4u, v[u].z, q),
                                kept(nib[u] & 8u, v[u].w, q)));
    }
  }
}

// Enough blocks to cover every tile, at most kBlocksPerSm a multiprocessor
// (the rest of the tiles by the grid-stride loop).
dim3 grid_of(int64_t numel) {
  const int64_t groups = (numel + 3) / 4;
  const int64_t tiles = (groups + kTileGroups - 1) / kTileGroups;
  const int64_t need = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  return dim3((unsigned)(need < cap ? need : cap));
}

}  // namespace

// Launches K15's forward on `stream` (h and the packed bits from z) and
// returns cudaGetLastError().  mask holds (numel + 31) / 32 int32 words.
extern "C" int relu_dropout_launch(const float* z, float* h, int32_t* mask,
                                   int64_t numel, float p, float q,
                                   uint32_t k0, uint32_t k1, uint32_t epoch,
                                   uint32_t layer, void* stream) {
  if (numel > 0)
    forward_kernel<<<grid_of(numel), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        z, h, mask, numel, p, q, k0, k1, epoch, layer);
  return (int)cudaGetLastError();
}

// Launches K15's backward on `stream` (dz from the forward's bits and dh)
// and returns cudaGetLastError().
extern "C" int relu_dropout_backward_launch(const int32_t* mask,
                                            const float* dh, float* dz,
                                            int64_t numel, float q,
                                            void* stream) {
  if (numel > 0)
    backward_kernel<<<grid_of(numel), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(mask, dh, dz,
                                                           numel, q);
  return (int)cudaGetLastError();
}
