// K5: CSR SpMM fused with the recurrences that consume it, hand-written for
// Hopper (sm_90a).
//
// Replaces the loop bodies of the JAX package's spectral programs in
// cleora_tpu/algorithms.py: _weighted_sum_jit (:125-128, RandNE's
// acc += w_i * N^i R), _cheb_jit (:201-212, ProNE's Chebyshev step),
// katz in _hope_rsvd_jit (:285-294, the Neumann series of HOPE) and the
// walk `y = spmm; acc += y` of _netmf_block_jit (:595-597):
//
//   s         = sum_{e in row i} vals[e] * x[indices[e], :]
//   out[i, :] = a * s + b * self[i, :] + c * z[i, :]
//   acc[i, :] += d * out[i, :]                       (when acc is given)
//
// self is x itself on one device.  In the sharded siblings
// (parallel/algorithms.py, the port of cleora_tpu/parallel/algorithms.py)
// x is the gather table (the all-gathered rows or the received halo slab,
// which may have more or fewer rows than the shard) and self the shard's
// own N rows, as K1's residual operand is in the sharded loop.  z and acc
// may be null.  The b term is skipped when b == 0 and the c term when z is
// null, so neither row is read then.  Everything is float32.
//
// Bound on the card: bytes.  A call reads the CSR (8 (N+1) + 8 nnz B) and x,
// optionally self, z and acc (4 N D B each), and writes out and acc
// (4 N D B each), for 2 nnz D + 6 N D flops: a fraction of a flop per byte.
//
// Design: XLA fuses the elementwise tail of each step into the program
// around its SpMM; unfused, each step would re-read and re-write three to
// five state-sized tensors.  Here the thread that holds a row's sum in
// registers (K1's row walk: one row of threads per output row, one float4
// column group per thread and column tile, four gathers in flight) applies
// the whole step before it stores, so every state tensor moves once.  The
// tail is written with explicit round-to-nearest multiplies and adds in the
// plain version's order (no fused multiply-add), so the two differ only by
// the order of the row sum.  out must not alias x (other rows gather it).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void axpy4(float4& acc, float v, const float4& a) {
  acc.x += v * a.x;
  acc.y += v * a.y;
  acc.z += v * a.z;
  acc.w += v * a.w;
}

// a*s + b*xr + c*zr in the plain version's order and rounding
__device__ __forceinline__ float tail(float s, float a, float b, float xr,
                                      bool has_z, float c, float zr) {
  float o = __fmul_rn(a, s);
  if (b != 0.f) o = __fadd_rn(o, __fmul_rn(b, xr));
  if (has_z) o = __fadd_rn(o, __fmul_rn(c, zr));
  return o;
}

__global__ void spmm_axpy_vec4(const int64_t* __restrict__ indptr,
                               const int32_t* __restrict__ indices,
                               const float* __restrict__ vals,
                               const float* __restrict__ x,
                               const float* __restrict__ self,
                               const float* __restrict__ z, float* acc_out,
                               float* __restrict__ out, int64_t n_rows,
                               int64_t d, float a, float b, float c,
                               float dd) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  const int64_t groups = d >> 2;
  const bool has_z = z != nullptr;
  for (int64_t g = threadIdx.x; g < groups; g += blockDim.x) {
    const int64_t col0 = g << 2;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    int64_t e = start;
    for (; e + 4 <= end; e += 4) {
      const int64_t c0 = __ldg(indices + e), c1 = __ldg(indices + e + 1);
      const int64_t c2 = __ldg(indices + e + 2), c3 = __ldg(indices + e + 3);
      const float v0 = __ldg(vals + e), v1 = __ldg(vals + e + 1);
      const float v2 = __ldg(vals + e + 2), v3 = __ldg(vals + e + 3);
      const float4 a0 = load4(x + c0 * d + col0);
      const float4 a1 = load4(x + c1 * d + col0);
      const float4 a2 = load4(x + c2 * d + col0);
      const float4 a3 = load4(x + c3 * d + col0);
      axpy4(s, v0, a0);
      axpy4(s, v1, a1);
      axpy4(s, v2, a2);
      axpy4(s, v3, a3);
    }
    for (; e < end; ++e) {
      const int64_t col = __ldg(indices + e);
      axpy4(s, __ldg(vals + e), load4(x + col * d + col0));
    }
    const int64_t at = row * d + col0;
    float4 xr = make_float4(0.f, 0.f, 0.f, 0.f), zr = xr;
    if (b != 0.f) xr = load4(self + at);
    if (has_z) zr = load4(z + at);
    float4 o;
    o.x = tail(s.x, a, b, xr.x, has_z, c, zr.x);
    o.y = tail(s.y, a, b, xr.y, has_z, c, zr.y);
    o.z = tail(s.z, a, b, xr.z, has_z, c, zr.z);
    o.w = tail(s.w, a, b, xr.w, has_z, c, zr.w);
    *reinterpret_cast<float4*>(out + at) = o;
    if (acc_out != nullptr) {
      float4 u = *reinterpret_cast<const float4*>(acc_out + at);
      u.x = __fadd_rn(u.x, __fmul_rn(dd, o.x));
      u.y = __fadd_rn(u.y, __fmul_rn(dd, o.y));
      u.z = __fadd_rn(u.z, __fmul_rn(dd, o.z));
      u.w = __fadd_rn(u.w, __fmul_rn(dd, o.w));
      *reinterpret_cast<float4*>(acc_out + at) = u;
    }
  }
}

__global__ void spmm_axpy_scalar(const int64_t* __restrict__ indptr,
                                 const int32_t* __restrict__ indices,
                                 const float* __restrict__ vals,
                                 const float* __restrict__ x,
                                 const float* __restrict__ self,
                                 const float* __restrict__ z, float* acc_out,
                                 float* __restrict__ out, int64_t n_rows,
                                 int64_t d, float a, float b, float c,
                                 float dd) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  const bool has_z = z != nullptr;
  for (int64_t col0 = threadIdx.x; col0 < d; col0 += blockDim.x) {
    float s = 0.f;
    for (int64_t e = start; e < end; ++e) {
      const int64_t col = __ldg(indices + e);
      s += __ldg(vals + e) * __ldg(x + col * d + col0);
    }
    const int64_t at = row * d + col0;
    const float xr = b != 0.f ? __ldg(self + at) : 0.f;
    const float zr = has_z ? __ldg(z + at) : 0.f;
    const float o = tail(s, a, b, xr, has_z, c, zr);
    out[at] = o;
    if (acc_out != nullptr) {
      acc_out[at] = __fadd_rn(acc_out[at], __fmul_rn(dd, o));
    }
  }
}

}  // namespace

// Launches K5 on `stream` and returns cudaGetLastError().  `self` is the
// shard's own rows (x on one device); `z` and `acc` may be null.  `vec4`
// requires d % 4 == 0 and every tensor aligned to 16 bytes (checked by the
// Python wrapper).
extern "C" int spmm_axpy_launch(const int64_t* indptr, const int32_t* indices,
                                const float* vals, const float* x,
                                const float* self, const float* z,
                                float* acc, float* out,
                                int64_t n_rows, int64_t d, float a, float b,
                                float c, float dd, int vec4, void* stream) {
  if (n_rows > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t groups = vec4 ? d / 4 : d;
    const int tx = (int)(groups < 256 ? groups : 256);
    const int ty = 256 / tx > 0 ? 256 / tx : 1;
    const dim3 block(tx, ty);
    const dim3 grid((unsigned)((n_rows + ty - 1) / ty));
    if (vec4) {
      spmm_axpy_vec4<<<grid, block, 0, s>>>(indptr, indices, vals, x, self,
                                            z, acc, out, n_rows, d, a, b, c,
                                            dd);
    } else {
      spmm_axpy_scalar<<<grid, block, 0, s>>>(indptr, indices, vals, x,
                                              self, z, acc, out, n_rows, d,
                                              a, b, c, dd);
    }
  }
  return (int)cudaGetLastError();
}
