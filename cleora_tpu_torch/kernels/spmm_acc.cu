// K19: round-accumulate SpMM, hand-written for Hopper (sm_90a).
//
// Replaces the per-round segment-sum of the overlapped halo exchange,
// `seg` in cleora_tpu/parallel/embed.py:_overlap_propagate (:49-54),
// applied to the shard's own rows at :66 and to each received slab at :72:
//
//   acc[row_ids[i], :] += sum_{e in [indptr[i], indptr[i+1])}
//                             vals[e] * table[cols[e], :]
//
// One call is one round of one shard: a compact CSR that lists only the
// local rows with an edge from that round's column owner (ascending, each
// once), and the table the round gathers from: the shard's own state in
// round 0, the received (M, D) slab after it.  acc is the float32
// (rows_per_shard, D) accumulator, updated in place; table is float32 or
// bfloat16 (the state's dtype, as the slab travels).
//
// Bound on the card: bytes.  A call reads row_ids and indptr (4 R + 8 (R+1)
// B), cols and vals (8 E B), one table row per distinct column the round
// names, and the R accumulator rows, and writes those rows back; it does
// 2 E D flops, a fraction of a flop per byte.
//
// Design: K1's, with the TPU's scatter-add made a register sum.  A row of
// threads (threadIdx.y) owns one compact row; each thread owns one float4
// column group (4 bf16 values for a bf16 table) per column tile and walks
// the row's edges in order, four gathers in flight, summing in edge order
// as K1 does.  The sum is added to acc once at the end, so no atomics are
// needed: a row appears once per round, and the rounds run in order on
// one stream.  Unlike K1 (a fresh output per call) or K5's acc mode (which
// also writes a full (rows, D) output), a round that touches few rows
// launches few blocks and moves only those rows.  D not divisible by 4, or
// a misaligned table or acc, takes the scalar instantiation.

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
__global__ void spmm_acc_vec4(const int32_t* __restrict__ row_ids,
                              const int64_t* __restrict__ indptr,
                              const int32_t* __restrict__ cols,
                              const float* __restrict__ vals,
                              const T* __restrict__ table,
                              float* __restrict__ acc, int64_t n_rows,
                              int64_t d) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n_rows) return;
  const int64_t start = indptr[i];
  const int64_t end = indptr[i + 1];
  float* dst = acc + (int64_t)row_ids[i] * d;
  const int64_t groups = d >> 2;
  for (int64_t g = threadIdx.x; g < groups; g += blockDim.x) {
    const int64_t c = g << 2;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    int64_t e = start;
    for (; e + 4 <= end; e += 4) {
      const int64_t c0 = __ldg(cols + e), c1 = __ldg(cols + e + 1);
      const int64_t c2 = __ldg(cols + e + 2), c3 = __ldg(cols + e + 3);
      const float v0 = __ldg(vals + e), v1 = __ldg(vals + e + 1);
      const float v2 = __ldg(vals + e + 2), v3 = __ldg(vals + e + 3);
      const float4 a0 = load4(table + c0 * d + c);
      const float4 a1 = load4(table + c1 * d + c);
      const float4 a2 = load4(table + c2 * d + c);
      const float4 a3 = load4(table + c3 * d + c);
      axpy4(sum, v0, a0);
      axpy4(sum, v1, a1);
      axpy4(sum, v2, a2);
      axpy4(sum, v3, a3);
    }
    for (; e < end; ++e) {
      const int64_t col = __ldg(cols + e);
      axpy4(sum, __ldg(vals + e), load4(table + col * d + c));
    }
    float4* out = reinterpret_cast<float4*>(dst + c);
    float4 a = *out;
    a.x += sum.x;
    a.y += sum.y;
    a.z += sum.z;
    a.w += sum.w;
    *out = a;
  }
}

template <typename T>
__global__ void spmm_acc_scalar(const int32_t* __restrict__ row_ids,
                                const int64_t* __restrict__ indptr,
                                const int32_t* __restrict__ cols,
                                const float* __restrict__ vals,
                                const T* __restrict__ table,
                                float* __restrict__ acc, int64_t n_rows,
                                int64_t d) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n_rows) return;
  const int64_t start = indptr[i];
  const int64_t end = indptr[i + 1];
  float* dst = acc + (int64_t)row_ids[i] * d;
  for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
    float sum = 0.f;
    for (int64_t e = start; e < end; ++e) {
      const int64_t col = __ldg(cols + e);
      sum += __ldg(vals + e) * load1(table + col * d + c);
    }
    dst[c] += sum;
  }
}

template <typename T>
void launch(const int32_t* row_ids, const int64_t* indptr,
            const int32_t* cols, const float* vals, const T* table,
            float* acc, int64_t n_rows, int64_t d, int vec4,
            cudaStream_t stream) {
  const int64_t groups = vec4 ? d / 4 : d;
  const int tx = (int)(groups < 256 ? groups : 256);
  const int ty = 256 / tx > 0 ? 256 / tx : 1;
  const dim3 block(tx, ty);
  const dim3 grid((unsigned)((n_rows + ty - 1) / ty));
  if (vec4) {
    spmm_acc_vec4<T><<<grid, block, 0, stream>>>(row_ids, indptr, cols, vals,
                                                  table, acc, n_rows, d);
  } else {
    spmm_acc_scalar<T><<<grid, block, 0, stream>>>(row_ids, indptr, cols,
                                                    vals, table, acc, n_rows,
                                                    d);
  }
}

}  // namespace

// Launches K19 on `stream` and returns cudaGetLastError().  A round with
// no rows (or D = 0) launches nothing: a grid of 0 blocks is an invalid
// configuration.  `vec4` requires d % 4 == 0, table aligned to 4 elements
// and acc to 16 bytes (checked by the Python wrapper); every row id must
// lie in [0, rows of acc) and every col in [0, rows of table) (checked on
// the host when the plan is built).
extern "C" int spmm_acc_launch(const int32_t* row_ids, const int64_t* indptr,
                               const int32_t* cols, const float* vals,
                               const void* table, int table_bf16, float* acc,
                               int64_t n_rows, int64_t d, int vec4,
                               void* stream) {
  if (n_rows > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (table_bf16) {
      launch(row_ids, indptr, cols, vals,
             static_cast<const __nv_bfloat16*>(table), acc, n_rows, d, vec4,
             s);
    } else {
      launch(row_ids, indptr, cols, vals, static_cast<const float*>(table),
             acc, n_rows, d, vec4, s);
    }
  }
  return (int)cudaGetLastError();
}
