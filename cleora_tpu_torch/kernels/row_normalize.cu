// K2: per-row L2 / L1 normalisation in place, hand-written for Hopper
// (sm_90a).
//
// Replaces the JAX package's cleora_tpu/ops/normalize.py l2_normalize (:15)
// and l1_normalize (:20):
//
//   x[r, :] /= max(||x[r, :]||_2, 1e-10)      (mode 0)
//   x[r, :] /= max(||x[r, :]||_1, 1e-10)      (mode 1)
//
// x is float32 (N, D), row-major.
//
// Bound on the card: bytes.  A call must read x once and write it once
// (8 N D B) for 3 N D flops.
//
// Design: rows of up to 1,024 columns take K1's row team and epilogue
// (row_team.cuh: a team of L lanes a row, the row held in registers, one
// butterfly over the team for the sum, one division and one store), so K2
// after K19's round sums (halo="overlap") gives what K1 with the
// normalisation fused gives, bit for bit.  Wider rows keep a kernel of
// their own, one block per row: such a row does not fit a warp's registers
// (8 float4 slots a lane), so it is read twice, and a block of 256 threads
// puts 8 warps on that row where a team would put one.  Each thread sums
// its float4 column groups, the block reduces with warp shuffles and one
// shared-memory slot per warp, and a second pass divides the row (the row
// was just read by the same threads, so the second read is served from
// L1/L2).  K1 never normalises such rows, so nothing asks the two kernels
// to round alike.  The division is IEEE round-to-nearest, as in the JAX
// version.

#include <cstdint>

#include <cuda_runtime.h>

#include "row_team.cuh"

namespace {

template <int MODE>
__device__ __forceinline__ float term(float v) {
  return MODE == 0 ? v * v : fabsf(v);
}

template <int MODE>
__global__ void row_normalize_kernel(float* __restrict__ x, int64_t d,
                                     int vec4) {
  __shared__ float partial[32];
  float* xr = x + (int64_t)blockIdx.x * d;
  const int tid = threadIdx.x;
  float s = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int64_t g = tid; g < (d >> 2); g += blockDim.x) {
      const float4 v = x4[g];
      s += term<MODE>(v.x) + term<MODE>(v.y) + term<MODE>(v.z) +
           term<MODE>(v.w);
    }
  } else {
    for (int64_t c = tid; c < d; c += blockDim.x) s += term<MODE>(xr[c]);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) partial[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) partial[0] = s;
  }
  __syncthreads();
  const float norm = MODE == 0 ? sqrtf(partial[0]) : partial[0];
  const float denom = fmaxf(norm, 1e-10f);
  if (vec4) {
    float4* x4 = reinterpret_cast<float4*>(xr);
    for (int64_t g = tid; g < (d >> 2); g += blockDim.x) {
      float4 v = x4[g];
      v.x /= denom;
      v.y /= denom;
      v.z /= denom;
      v.w /= denom;
      x4[g] = v;
    }
  } else {
    for (int64_t c = tid; c < d; c += blockDim.x) xr[c] /= denom;
  }
}

constexpr int kTeamThreads = 256;

// Rows of up to 1,024 columns: K1's row team (row_team.cuh), the row held
// in registers, its layout and normalisation those of K1's epilogue.
template <int MODE, bool kVec4, int kS>
__global__ void __launch_bounds__(kTeamThreads)
    row_normalize_team(float* __restrict__ x, int64_t n_rows, int64_t d,
                       int L) {
  constexpr int kP = kVec4 ? 4 : 1;
  const int sub = threadIdx.x & (L - 1);
  const int64_t row =
      (int64_t)blockIdx.x * (kTeamThreads / L) + threadIdx.x / L;
  const bool live = row < n_rows;
  float* xr = x + (live ? row : 0) * d;
  bool ok[kS];
  float a[kS][kP];
#pragma unroll
  for (int t = 0; t < kS; ++t) {
    const int64_t c = (int64_t)(sub + L * t) * kP;
    ok[t] = live && c < d;
#pragma unroll
    for (int q = 0; q < kP; ++q) a[t][q] = 0.f;
    if (!ok[t]) continue;
    if constexpr (kVec4) {
      const float4 v = *reinterpret_cast<const float4*>(xr + c);
      a[t][0] = v.x;
      a[t][1] = v.y;
      a[t][2] = v.z;
      a[t][3] = v.w;
    } else {
      a[t][0] = xr[c];
    }
  }
  row_team::normalize_team<kS, kP>(a, MODE + 1, L);
  row_team::store_team<kS, kP>(a, ok, xr, L, sub);
}

template <int MODE, bool kVec4>
void launch_team(float* x, int64_t n_rows, int64_t d, int L, int slots,
                 cudaStream_t s) {
  const unsigned blocks =
      (unsigned)((n_rows + kTeamThreads / L - 1) / (kTeamThreads / L));
  switch (slots) {
    case 1: row_normalize_team<MODE, kVec4, 1><<<blocks, kTeamThreads, 0, s>>>(x, n_rows, d, L); break;
    case 2: row_normalize_team<MODE, kVec4, 2><<<blocks, kTeamThreads, 0, s>>>(x, n_rows, d, L); break;
    case 4: row_normalize_team<MODE, kVec4, 4><<<blocks, kTeamThreads, 0, s>>>(x, n_rows, d, L); break;
    case 8: row_normalize_team<MODE, kVec4, 8><<<blocks, kTeamThreads, 0, s>>>(x, n_rows, d, L); break;
    default:
      if constexpr (!kVec4) {
        if (slots == 16) {
          row_normalize_team<MODE, kVec4, 16><<<blocks, kTeamThreads, 0, s>>>(x, n_rows, d, L);
        } else {
          row_normalize_team<MODE, kVec4, 32><<<blocks, kTeamThreads, 0, s>>>(x, n_rows, d, L);
        }
      }
  }
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError().  mode 0 = l2,
// 1 = l1.  `vec4` requires d % 4 == 0 and x 16-byte aligned (checked by the
// Python wrapper).  Rows index the grid's x dimension (at most 2^31 - 1).
extern "C" int row_normalize_launch(float* x, int64_t n_rows, int64_t d,
                                    int mode, int vec4, void* stream) {
  if (n_rows > 0 && d > 0 && d <= row_team::kMaxColumns) {
    const row_team::Layout lay = row_team::layout(d, vec4);
    const int L = lay.L, slots = lay.slots;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == 0) {
      vec4 ? launch_team<0, true>(x, n_rows, d, L, slots, s)
           : launch_team<0, false>(x, n_rows, d, L, slots, s);
    } else {
      vec4 ? launch_team<1, true>(x, n_rows, d, L, slots, s)
           : launch_team<1, false>(x, n_rows, d, L, slots, s);
    }
  } else if (n_rows > 0 && d > 0) {
    const int64_t work = vec4 ? d / 4 : d;
    int threads = (int)((work + 31) / 32 * 32);
    if (threads > 256) threads = 256;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((unsigned)n_rows);
    if (mode == 0) {
      row_normalize_kernel<0><<<grid, threads, 0, s>>>(x, d, vec4);
    } else {
      row_normalize_kernel<1><<<grid, threads, 0, s>>>(x, d, vec4);
    }
  }
  return (int)cudaGetLastError();
}
