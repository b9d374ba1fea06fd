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
//
// The band form (log_clip_bands_launch) reads a band-major panel y
// (bands, n, g) and writes the row-major (n, m) L out of place, leaving y
// as it was:
//
//   L[i, g j + k] = clip1(y[j, i, k], r[i], c[g j + k])    for g j + k < m
//
// The blocked GraRep (algorithms.py) walks its panel band-major for K1's
// band form and needs the walk state unchanged for the next power, so this
// one pass replaces a copy of the panel and K7 in place on the copy.  With
// one band (g = m: the sharded GraRep's row-major panel over a halo plan)
// it is K7 out of place.  With bands of 32 columns a block
// transposes a tile of 32 rows by 8 bands through shared memory: it reads
// each band's 32 rows as one contiguous 4 KB piece and writes each row's
// 256 columns as one 1 KB run (a warp stores 512 contiguous bytes), where
// a thread a band element would write 128-byte pieces at the row stride.
// The element arithmetic is clip1's, so L is bitwise K7's in-place result
// on the row-major panel.

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

// K7 out of place over row-major (n, m): src unchanged.
__global__ void log_clip_copy_kernel(const float* __restrict__ src,
                                     const float* __restrict__ r,
                                     const float* __restrict__ c,
                                     float* __restrict__ dst, int64_t n,
                                     int64_t m, float floor_, float offset,
                                     int vec4) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n) return;
  const bool has_r = r != nullptr, has_c = c != nullptr;
  const float ri = has_r ? __ldg(r + row) : 1.f;
  const float* sr = src + row * m;
  float* dr = dst + row * m;
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(sr);
    float4* d4 = reinterpret_cast<float4*>(dr);
    for (int64_t g = threadIdx.x; g < (m >> 2); g += blockDim.x) {
      float4 v = __ldcs(s4 + g);
      float4 cj = make_float4(1.f, 1.f, 1.f, 1.f);
      if (has_c) cj = __ldg(reinterpret_cast<const float4*>(c) + g);
      v.x = clip1(v.x, ri, cj.x, has_r, has_c, floor_, offset);
      v.y = clip1(v.y, ri, cj.y, has_r, has_c, floor_, offset);
      v.z = clip1(v.z, ri, cj.z, has_r, has_c, floor_, offset);
      v.w = clip1(v.w, ri, cj.w, has_r, has_c, floor_, offset);
      d4[g] = v;
    }
  } else {
    for (int64_t j = threadIdx.x; j < m; j += blockDim.x) {
      const float cj = has_c ? __ldg(c + j) : 1.f;
      dr[j] = clip1(sr[j], ri, cj, has_r, has_c, floor_, offset);
    }
  }
}

constexpr int kBandG = 32;     // columns a band: kernels.BAND_COLUMNS
constexpr int kTileRows = 32;  // rows a block
constexpr int kTileBands = 8;  // bands a block: 256 columns
constexpr int kTileGroups = kTileBands * kBandG / 4;  // float4s a tile row

// A block: rows [32 blockIdx.x, +32) of bands [8 blockIdx.y, +8).  Thread
// t reads float4 t % 8 of row t / 8 of each band, clips it and parks it in
// the tile; then each warp writes 32 float4s of one tile row.
__global__ void __launch_bounds__(256)
    log_clip_bands_kernel(const float* __restrict__ y,
                          const float* __restrict__ r,
                          const float* __restrict__ c,
                          float* __restrict__ out, int64_t n, int64_t m,
                          int64_t bands, float floor_, float offset,
                          int vec4) {
  __shared__ float4 tile[kTileRows][kTileGroups];
  const int64_t r0 = (int64_t)blockIdx.x * kTileRows;
  const int64_t b0 = (int64_t)blockIdx.y * kTileBands;
  const bool has_r = r != nullptr, has_c = c != nullptr;
  const int t = threadIdx.x;
  const int i = t >> 3, q = t & 7;
  const int64_t row = r0 + i;
  const float ri = has_r && row < n ? __ldg(r + row) : 1.f;
#pragma unroll
  for (int jj = 0; jj < kTileBands; ++jj) {
    const int64_t band = b0 + jj;
    if (band >= bands) break;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) {
      v = __ldcs(reinterpret_cast<const float4*>(y + (band * n + row) * kBandG)
                 + q);
      const int64_t col = band * kBandG + 4 * q;
      float cj[4] = {1.f, 1.f, 1.f, 1.f};
      if (has_c) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < m) cj[e] = __ldg(c + col + e);
      }
      v.x = clip1(v.x, ri, cj[0], has_r, has_c, floor_, offset);
      v.y = clip1(v.y, ri, cj[1], has_r, has_c, floor_, offset);
      v.z = clip1(v.z, ri, cj[2], has_r, has_c, floor_, offset);
      v.w = clip1(v.w, ri, cj[3], has_r, has_c, floor_, offset);
    }
    tile[i][jj * (kBandG / 4) + q] = v;
  }
  __syncthreads();
  const int g = t & (kTileGroups - 1);
  const int64_t col = b0 * kBandG + 4 * g;
  if (col >= m) return;
#pragma unroll
  for (int k = 0; k < kTileRows * kTileGroups / 256; ++k) {
    const int i2 = k * (256 / kTileGroups) + (t / kTileGroups);
    const int64_t row2 = r0 + i2;
    if (row2 >= n) break;
    const float4 v = tile[i2][g];
    float* o = out + row2 * m + col;
    if (vec4) {
      __stcs(reinterpret_cast<float4*>(o), v);
    } else {
      const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < m) o[e] = e4[e];
    }
  }
}

}  // namespace

// Launches K7's band form on `stream` and returns cudaGetLastError(): y is
// the (bands, n, g) panel (float32, aligned to 16 bytes), out the (n, m)
// result.  Either one band of g = m columns (K7 out of place; `vec4`
// requires m % 4 == 0 and c, when given, aligned to 16 bytes) or bands of
// g = 32 with (bands - 1) * 32 < m <= bands * 32 (`vec4` requires m % 4 ==
// 0).  `r` (n) and `c` (m) may be null.
extern "C" int log_clip_bands_launch(const float* y, const float* r,
                                     const float* c, float* out, int64_t n,
                                     int64_t m, int64_t bands, int64_t g,
                                     float floor_, float offset, int vec4,
                                     void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bands == 1 && g == m) {
    const int64_t groups = vec4 ? m / 4 : m;
    const int tx = (int)(groups < 256 ? groups : 256);
    const int ty = 256 / tx > 0 ? 256 / tx : 1;
    const dim3 block(tx, ty);
    const dim3 grid((unsigned)((n + ty - 1) / ty));
    log_clip_copy_kernel<<<grid, block, 0, s>>>(y, r, c, out, n, m, floor_,
                                                offset, vec4);
  } else if (g == kBandG && (bands - 1) * kBandG < m && m <= bands * kBandG) {
    const int64_t tiles = (bands + kTileBands - 1) / kTileBands;
    if (tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((n + kTileRows - 1) / kTileRows),
                    (unsigned)tiles);
    log_clip_bands_kernel<<<grid, 256, 0, s>>>(y, r, c, out, n, m, bands,
                                               floor_, offset, vec4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

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
