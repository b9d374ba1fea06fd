// K1: CSR SpMM propagate, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's propagate programs: cleora_tpu/ops/spmm_ell.py
// spmm_ell (:437) with its bucket body _bucket_out (:421), and
// cleora_tpu/ops/spmm.py spmm_inner (:249, flat path :319-324).  The
// residual mix of cleora_tpu/ops/loop.py:65-66 is fused into the epilogue:
//
//   out[r, :] = sum_{e in row r} vals[e] * x[indices[e], :]
//   out[r, :] = keep * out[r, :] + w * res[r, :]          when w > 0
//
// res is x itself on one device.  In the sharded loop (parallel/embed.py)
// x is the gather table (the all-gathered state or the received halo slab,
// which may have fewer rows than the shard) and res the shard's own state,
// as in cleora_tpu/parallel/embed.py:192-193.  x and res are both float32
// or both bfloat16; the sum is always float32 and out is float32.
//
// Bound on the card: bytes.  A call reads indptr (8 (N+1) B), indices and
// vals (8 nnz B) and one row of x per edge (nnz * D * sizeof(x) B), and
// writes out (4 N D B); it does 2 nnz D flops, about a quarter of a flop per
// byte, far below the card's balance point.
//
// Design: the TPU needed a degree-bucketed ELL layout because XLA cannot
// fuse a scatter with the gather that feeds it.  Here each output row is
// owned by threadIdx.y's row of threads, which keeps the running sum in
// registers and writes the row once, so plain CSR in original row order
// suffices.  Each thread owns one float4 column group (4 bf16 for bf16 x)
// per column tile and walks the row's edges in order; every thread of the
// row loads the same (col, val) pair, which the memory system broadcasts.
// Four edges are loaded before they are summed so four gathers are in
// flight per thread; the sum itself runs in edge order.  A hub row simply
// loops longer.  D not divisible by 4 (or a misaligned x) takes the scalar
// instantiation.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void axpy4(float4& acc, float v, const float4& a) {
  acc.x += v * a.x;
  acc.y += v * a.y;
  acc.z += v * a.z;
  acc.w += v * a.w;
}

template <typename T>
__global__ void spmm_csr_vec4(const int64_t* __restrict__ indptr,
                              const int32_t* __restrict__ indices,
                              const float* __restrict__ vals,
                              const T* __restrict__ x,
                              const T* __restrict__ res, float* __restrict__ out,
                              int64_t n_rows, int64_t d, float keep, float w) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  const int64_t groups = d >> 2;
  for (int64_t g = threadIdx.x; g < groups; g += blockDim.x) {
    const int64_t c = g << 2;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int64_t e = start;
    for (; e + 4 <= end; e += 4) {
      const int64_t c0 = __ldg(indices + e), c1 = __ldg(indices + e + 1);
      const int64_t c2 = __ldg(indices + e + 2), c3 = __ldg(indices + e + 3);
      const float v0 = __ldg(vals + e), v1 = __ldg(vals + e + 1);
      const float v2 = __ldg(vals + e + 2), v3 = __ldg(vals + e + 3);
      const float4 a0 = load4(x + c0 * d + c);
      const float4 a1 = load4(x + c1 * d + c);
      const float4 a2 = load4(x + c2 * d + c);
      const float4 a3 = load4(x + c3 * d + c);
      axpy4(acc, v0, a0);
      axpy4(acc, v1, a1);
      axpy4(acc, v2, a2);
      axpy4(acc, v3, a3);
    }
    for (; e < end; ++e) {
      const int64_t col = __ldg(indices + e);
      axpy4(acc, __ldg(vals + e), load4(x + col * d + c));
    }
    if (w > 0.f) {
      const float4 xr = load4(res + row * d + c);
      acc.x = keep * acc.x + w * xr.x;
      acc.y = keep * acc.y + w * xr.y;
      acc.z = keep * acc.z + w * xr.z;
      acc.w = keep * acc.w + w * xr.w;
    }
    *reinterpret_cast<float4*>(out + row * d + c) = acc;
  }
}

template <typename T>
__global__ void spmm_csr_scalar(const int64_t* __restrict__ indptr,
                                const int32_t* __restrict__ indices,
                                const float* __restrict__ vals,
                                const T* __restrict__ x,
                                const T* __restrict__ res,
                                float* __restrict__ out, int64_t n_rows,
                                int64_t d, float keep, float w) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int64_t e = start; e < end; ++e) {
      const int64_t col = __ldg(indices + e);
      acc += __ldg(vals + e) * load1(x + col * d + c);
    }
    if (w > 0.f) acc = keep * acc + w * load1(res + row * d + c);
    out[row * d + c] = acc;
  }
}

template <typename T>
void launch(const int64_t* indptr, const int32_t* indices, const float* vals,
            const T* x, const T* res, float* out, int64_t n_rows, int64_t d,
            float keep, float w, int vec4, cudaStream_t stream) {
  const int64_t groups = vec4 ? d / 4 : d;
  const int tx = (int)(groups < 256 ? groups : 256);
  const int ty = 256 / tx > 0 ? 256 / tx : 1;
  const dim3 block(tx, ty);
  const dim3 grid((unsigned)((n_rows + ty - 1) / ty));
  if (vec4) {
    spmm_csr_vec4<T><<<grid, block, 0, stream>>>(indptr, indices, vals, x,
                                                  res, out, n_rows, d, keep,
                                                  w);
  } else {
    spmm_csr_scalar<T><<<grid, block, 0, stream>>>(indptr, indices, vals, x,
                                                    res, out, n_rows, d, keep,
                                                    w);
  }
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError().  `vec4` requires
// d % 4 == 0 and x and res aligned to 4 elements (checked by the Python
// wrapper).
extern "C" int spmm_csr_launch(const int64_t* indptr, const int32_t* indices,
                               const float* vals, const void* x, int x_bf16,
                               const void* res, float* out, int64_t n_rows,
                               int64_t d, float keep, float w, int vec4,
                               void* stream) {
  if (n_rows > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_bf16) {
      launch(indptr, indices, vals, static_cast<const __nv_bfloat16*>(x),
             static_cast<const __nv_bfloat16*>(res), out, n_rows, d, keep, w,
             vec4, s);
    } else {
      launch(indptr, indices, vals, static_cast<const float*>(x),
             static_cast<const float*>(res), out, n_rows, d, keep, w, vec4, s);
    }
  }
  return (int)cudaGetLastError();
}
