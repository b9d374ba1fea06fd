// K6: dense left-Markov transition P = D^-1 A scattered from CSR, with the
// degree vector and the volume, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's _dense_markov (cleora_tpu/algorithms.py:397-404):
//
//   A        = zeros(n, n).at[rows, cols].add(vals)     (duplicates sum)
//   deg[i]   = max(sum_j A[i, j], 1e-10)
//   P[i, :]  = A[i, :] / deg[i]
//   vol      = sum_ij A[i, j]
//
// The matrix arrives in CSR (row-sorted COO is CSR), P is float32 (n, n),
// deg float32 (n), vol one float64.
//
// Bound on the card: bytes.  A call reads the CSR (8 (n+1) + 8 nnz B) and
// must write P once (4 n^2 B); the arithmetic is one add per entry and one
// division per non-zero.
//
// Design: XLA runs a scatter-add into a zeroed buffer, a row reduction and
// a broadcast divide as three passes over n^2 floats.  Here one block owns
// a row: it zeroes the row, adds the row's values at their columns (atomics
// on the block's own row, so duplicate (row, col) entries sum), reduces the
// values to the row sum, and divides only the non-zero entries, while the
// row is still in cache.  The unclamped row sum goes into vol by one float64
// atomicAdd per row.  The division is IEEE round-to-nearest.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void dense_markov_kernel(const int64_t* __restrict__ indptr,
                                    const int32_t* __restrict__ indices,
                                    const float* __restrict__ vals, float* p,
                                    float* __restrict__ deg, double* vol,
                                    int64_t n, int vec4) {
  __shared__ float partial[32];
  const int64_t row = blockIdx.x;
  float* pr = p + row * n;
  const int tid = threadIdx.x;
  if (vec4) {
    float4* p4 = reinterpret_cast<float4*>(pr);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t g = tid; g < (n >> 2); g += blockDim.x) p4[g] = zero;
  } else {
    for (int64_t c = tid; c < n; c += blockDim.x) pr[c] = 0.f;
  }
  __syncthreads();
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  float s = 0.f;
  for (int64_t e = start + tid; e < end; e += blockDim.x) {
    const float v = __ldg(vals + e);
    atomicAdd(pr + __ldg(indices + e), v);
    s += v;
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) partial[warp] = s;
  __syncthreads();  // also orders the row's atomics before the divide
  if (warp == 0) {
    s = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) partial[0] = s;
  }
  __syncthreads();
  const float sum = partial[0];
  const float denom = fmaxf(sum, 1e-10f);
  if (tid == 0) {
    deg[row] = denom;
    atomicAdd(vol, (double)sum);
  }
  if (vec4) {
    float4* p4 = reinterpret_cast<float4*>(pr);
    for (int64_t g = tid; g < (n >> 2); g += blockDim.x) {
      float4 v = p4[g];
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) {
        v.x = __fdiv_rn(v.x, denom);
        v.y = __fdiv_rn(v.y, denom);
        v.z = __fdiv_rn(v.z, denom);
        v.w = __fdiv_rn(v.w, denom);
        p4[g] = v;
      }
    }
  } else {
    for (int64_t c = tid; c < n; c += blockDim.x) {
      const float v = pr[c];
      if (v != 0.f) pr[c] = __fdiv_rn(v, denom);
    }
  }
}

}  // namespace

// Launches K6 on `stream` and returns cudaGetLastError().  `vol` must hold
// 0.0 on entry.  `vec4` requires n % 4 == 0 and p aligned to 16 bytes
// (checked by the Python wrapper).  Rows index the grid's x dimension.
extern "C" int dense_markov_launch(const int64_t* indptr,
                                   const int32_t* indices, const float* vals,
                                   float* p, float* deg, double* vol,
                                   int64_t n, int vec4, void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    dense_markov_kernel<<<dim3((unsigned)n), 256, 0, s>>>(
        indptr, indices, vals, p, deg, vol, n, vec4);
  }
  return (int)cudaGetLastError();
}
