// K4: edge attention weights of one attention iteration, hand-written for
// Hopper (sm_90a).
//
// Replaces the score, masked row softmax and reweighting part of the JAX
// package's attention_step (cleora_tpu/__init__.py:505-526).  For each row r
// of the CSR matrix and each of its edges e, with xn the row-L2-normalised
// state:
//
//   s_e    = <xn[r], xn[indices[e]]> / T                 (edges with vals != 0)
//   m      = max_e s_e, or 0 when the row has no such edge (or it is not finite)
//   p_e    = exp(s_e - m)                                 (0 where vals == 0)
//   a_e    = p_e / max(sum_e p_e, 1e-10) * vals[e]
//   out[e] = a_e / max(sum_e a_e, 1e-10)
//
// out then serves as the values of the propagate SpMM (kernel K1).
//
// Bound on the card: bytes.  Read once, a call moves xn (4 N D B), the CSR
// (8 (N+1) + 8 nnz B) and out (4 nnz B); it does 2 nnz D flops for the
// scores, a quarter of a flop per byte.  The gather it really needs is one
// row of xn per edge, nnz * 4 D B, as for K1.
//
// Design: one block of 128 threads per row.  Pass 1 gives each warp one edge
// at a time: the lanes take float4 column groups of xn[r] and xn[col] (one
// float at a time when D % 4 != 0), and a warp shuffle sums the dot product.
// The scores go to `out`, which is the row's scratch: a row of any degree
// (a hub of 50,000 edges) needs no shared buffer.  Passes 2-4 give each
// thread a strided share of the row's edges, always the same share, so each
// thread rewrites only what it read itself: max, then exp and its sum, then
// the reweighting and its sum, then the division.  Each reduction is a warp
// shuffle and one shared slot per warp.  expf (not __expf) and IEEE division
// keep the rounding of the plain version.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <bool VEC4>
__device__ __forceinline__ float warp_dot(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          int64_t d, int lane) {
  float s = 0.f;
  if (VEC4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int64_t g = lane; g < (d >> 2); g += 32) {
      const float4 u = __ldg(a4 + g);
      const float4 v = __ldg(b4 + g);
      s += u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
    }
  } else {
    for (int64_t c = lane; c < d; c += 32) s += __ldg(a + c) * __ldg(b + c);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// Reduces v over the block; every thread gets the result.  The leading
// barrier lets one `partial` buffer serve consecutive reductions.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* partial, Op op,
                                              float identity) {
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? partial[lane] : identity;
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
    edge_attention_kernel(const int64_t* __restrict__ indptr,
                          const int32_t* __restrict__ indices,
                          const float* __restrict__ vals,
                          const float* __restrict__ xn, float* __restrict__ out,
                          int64_t d, float temperature) {
  __shared__ float partial[32];
  const int64_t row = blockIdx.x;
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  if (start == end) return;  // the whole block leaves: no barrier is skipped
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const float* xr = xn + row * d;

  // pass 1: scores into out (masked edges get -inf; they are never read as
  // scores again, only their vals)
  for (int64_t e = start + warp; e < end; e += warps) {
    if (vals[e] != 0.f) {
      const float dot = warp_dot<VEC4>(xr, xn + (int64_t)indices[e] * d, d, lane);
      if (lane == 0) out[e] = dot / temperature;
    } else if (lane == 0) {
      out[e] = -INFINITY;
    }
  }
  __syncthreads();

  // pass 2: the row max over valid edges
  float m = -INFINITY;
  for (int64_t e = start + tid; e < end; e += blockDim.x) {
    if (vals[e] != 0.f) m = fmaxf(m, out[e]);
  }
  m = block_reduce(m, partial, Max(), -INFINITY);
  if (!isfinite(m)) m = 0.f;

  // pass 3: p_e = exp(s_e - m) and its sum
  float sp = 0.f;
  for (int64_t e = start + tid; e < end; e += blockDim.x) {
    const float p = vals[e] != 0.f ? expf(out[e] - m) : 0.f;
    out[e] = p;
    sp += p;
  }
  const float dp = fmaxf(block_reduce(sp, partial, Sum(), 0.f), 1e-10f);

  // pass 4: a_e = p_e / max(sum p, 1e-10) * vals[e] and its sum
  float sa = 0.f;
  for (int64_t e = start + tid; e < end; e += blockDim.x) {
    const float a = out[e] / dp * vals[e];
    out[e] = a;
    sa += a;
  }
  const float da = fmaxf(block_reduce(sa, partial, Sum(), 0.f), 1e-10f);

  for (int64_t e = start + tid; e < end; e += blockDim.x) out[e] = out[e] / da;
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError().  `vec4` requires
// d % 4 == 0 and xn 16-byte aligned (checked by the Python wrapper).  Rows
// index the grid's x dimension (at most 2^31 - 1).
extern "C" int edge_attention_launch(const int64_t* indptr,
                                     const int32_t* indices, const float* vals,
                                     const float* xn, float* out,
                                     int64_t n_rows, int64_t d,
                                     float temperature, int vec4,
                                     void* stream) {
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((unsigned)n_rows);
    if (vec4) {
      edge_attention_kernel<true><<<grid, kThreads, 0, s>>>(
          indptr, indices, vals, xn, out, d, temperature);
    } else {
      edge_attention_kernel<false><<<grid, kThreads, 0, s>>>(
          indptr, indices, vals, xn, out, d, temperature);
    }
  }
  return (int)cudaGetLastError();
}
