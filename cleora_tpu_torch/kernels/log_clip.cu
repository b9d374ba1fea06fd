// K7: scaled log-clip in place, hand-written for Hopper (sm_90a).
//
// Replaces the elementwise tails of the JAX package's log-factorisations in
// cleora_tpu/algorithms.py: NetMF dense (:429-430) and block (:598-601),
// GraRep dense (:459-461) and block (:642-643):
//
//   x[i, j] = logf(fmaxf(x[i, j] * r[i] * c[j], floor)) - offset
//
// r and c may be null (a factor of 1).  NetMF: floor 1, offset 0, r and c
// the degree scales.  GraRep: floor 1e-10, offset logf(1e-10f), no scales.
// x is float32 (n, m), row-major.
//
// Bound on the card: bytes.  A call must read x once and write it once
// (8 n m B); r and c are n + m floats.
//
// Design: XLA fuses the scale, clip, log and shift into one pass; as
// separate PyTorch calls they are four passes over an (n, n) matrix.  Here
// one row of threads owns a row of x, each thread a float4 column group per
// column tile, and the whole tail is applied between one load and one store.
// logf is the accurate library function (not __logf) and the two products
// are round-to-nearest multiplies in the plain version's order, so the
// result is the plain version's.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clip1(float v, float ri, float cj, bool has_r,
                                       bool has_c, float floor_, float offset) {
  if (has_r) v = __fmul_rn(v, ri);
  if (has_c) v = __fmul_rn(v, cj);
  return __fsub_rn(logf(fmaxf(v, floor_)), offset);
}

__global__ void log_clip_kernel(float* __restrict__ x,
                                const float* __restrict__ r,
                                const float* __restrict__ c, int64_t n,
                                int64_t m, float floor_, float offset,
                                int vec4) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n) return;
  const bool has_r = r != nullptr, has_c = c != nullptr;
  const float ri = has_r ? __ldg(r + row) : 1.f;
  float* xr = x + row * m;
  if (vec4) {
    float4* x4 = reinterpret_cast<float4*>(xr);
    for (int64_t g = threadIdx.x; g < (m >> 2); g += blockDim.x) {
      float4 v = x4[g];
      float4 cj = make_float4(1.f, 1.f, 1.f, 1.f);
      if (has_c) cj = __ldg(reinterpret_cast<const float4*>(c) + g);
      v.x = clip1(v.x, ri, cj.x, has_r, has_c, floor_, offset);
      v.y = clip1(v.y, ri, cj.y, has_r, has_c, floor_, offset);
      v.z = clip1(v.z, ri, cj.z, has_r, has_c, floor_, offset);
      v.w = clip1(v.w, ri, cj.w, has_r, has_c, floor_, offset);
      x4[g] = v;
    }
  } else {
    for (int64_t j = threadIdx.x; j < m; j += blockDim.x) {
      const float cj = has_c ? __ldg(c + j) : 1.f;
      xr[j] = clip1(xr[j], ri, cj, has_r, has_c, floor_, offset);
    }
  }
}

}  // namespace

// Launches K7 on `stream` and returns cudaGetLastError().  `r` and `c` may
// be null.  `vec4` requires m % 4 == 0 and x (and c, when given) aligned to
// 16 bytes (checked by the Python wrapper).
extern "C" int log_clip_launch(float* x, const float* r, const float* c,
                               int64_t n, int64_t m, float floor_,
                               float offset, int vec4, void* stream) {
  if (n > 0 && m > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t groups = vec4 ? m / 4 : m;
    const int tx = (int)(groups < 256 ? groups : 256);
    const int ty = 256 / tx > 0 ? 256 / tx : 1;
    const dim3 block(tx, ty);
    const dim3 grid((unsigned)((n + ty - 1) / ty));
    log_clip_kernel<<<grid, block, 0, s>>>(x, r, c, n, m, floor_, offset,
                                           vec4);
  }
  return (int)cudaGetLastError();
}
