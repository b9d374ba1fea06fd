// K14: one label-propagation step, hand-written for Hopper (sm_90a).
//
// Replaces the loop body of the JAX package's _label_prop_jit
// (cleora_tpu/classify.py:88-105), an SpMM over S = D^-1 A
// (cleora_tpu/ops/spmm.py spmm_inner, :249) with its tail and clamp:
//
//   s         = sum_{e in row i} vals[e] * f[indices[e], :]
//   out[i, :] = mask[i] ? y[i, :] : alpha * s + beta * y[i, :]
//
// with f, y and out float32 (n, C) and beta = 1 - alpha rounded to float32
// by the caller.  C is the class count: 2 to 50, seldom a multiple of 4.
//
// Bound on the card: bytes.  A step reads the CSR (8 (n+1) + 8 nnz B), f and
// y (4 n C B each) and the mask (n B), and writes out (4 n C B); it does
// 2 nnz C + 3 n C flops.
//
// Design: K1's and K5's layout (a row of up to 256 threads per output row,
// one float4 column group each) leaves most lanes idle at C = 7.  Here a
// group of LANES consecutive lanes owns a row, LANES the power of two that
// covers C up to a warp (2, 4, ..., 32), and a warp holds 32 / LANES rows.
// A lane sums column c = lane, lane + LANES, ... of its row over the row's
// edges in edge order; every lane of the group loads the same (col, val)
// pair, and the group's loads of a gathered row of f are contiguous.  A
// clamped row copies y and reads no edge.  Every product and sum is a
// round-to-nearest intrinsic (no fused multiply-add), so the row sum is the
// plain version's gather-scale-add up to the order of the additions, and the
// tail is its tail exactly.  out must not alias f (other rows gather it).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <int LANES>
__global__ void label_prop_kernel(const int64_t* __restrict__ indptr,
                                  const int32_t* __restrict__ indices,
                                  const float* __restrict__ vals,
                                  const float* __restrict__ f,
                                  const float* __restrict__ y,
                                  const uint8_t* __restrict__ mask,
                                  float* __restrict__ out, int64_t n_rows,
                                  int64_t c, float alpha, float beta) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = t / LANES;
  const int lane = (int)(t % LANES);
  if (row >= n_rows) return;
  const int64_t at = row * c;
  if (__ldg(mask + row)) {
    for (int64_t k = lane; k < c; k += LANES) out[at + k] = __ldg(y + at + k);
    return;
  }
  const int64_t start = __ldg(indptr + row);
  const int64_t end = __ldg(indptr + row + 1);
  for (int64_t k = lane; k < c; k += LANES) {
    float s = 0.f;
    for (int64_t e = start; e < end; ++e) {
      const int64_t col = __ldg(indices + e);
      s = __fadd_rn(s, __fmul_rn(__ldg(f + col * c + k), __ldg(vals + e)));
    }
    out[at + k] = __fadd_rn(__fmul_rn(s, alpha), __fmul_rn(__ldg(y + at + k), beta));
  }
}

template <int LANES>
void launch(const int64_t* indptr, const int32_t* indices, const float* vals,
            const float* f, const float* y, const uint8_t* mask, float* out,
            int64_t n_rows, int64_t c, float alpha, float beta,
            cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n_rows * LANES;
  const dim3 grid((unsigned)((total + threads - 1) / threads));
  label_prop_kernel<LANES><<<grid, threads, 0, stream>>>(
      indptr, indices, vals, f, y, mask, out, n_rows, c, alpha, beta);
}

}  // namespace

// Launches K14 on `stream` and returns cudaGetLastError().  `mask` holds one
// byte per row (a torch.bool tensor), nonzero for a clamped row.
extern "C" int label_prop_launch(const int64_t* indptr, const int32_t* indices,
                                 const float* vals, const float* f,
                                 const float* y, const uint8_t* mask,
                                 float* out, int64_t n_rows, int64_t c,
                                 float alpha, float beta, void* stream) {
  if (n_rows > 0 && c > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (c <= 2) {
      launch<2>(indptr, indices, vals, f, y, mask, out, n_rows, c, alpha, beta, s);
    } else if (c <= 4) {
      launch<4>(indptr, indices, vals, f, y, mask, out, n_rows, c, alpha, beta, s);
    } else if (c <= 8) {
      launch<8>(indptr, indices, vals, f, y, mask, out, n_rows, c, alpha, beta, s);
    } else if (c <= 16) {
      launch<16>(indptr, indices, vals, f, y, mask, out, n_rows, c, alpha, beta, s);
    } else {
      launch<32>(indptr, indices, vals, f, y, mask, out, n_rows, c, alpha, beta, s);
    }
  }
  return (int)cudaGetLastError();
}
