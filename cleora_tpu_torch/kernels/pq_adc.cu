// K13: product-quantisation asymmetric-distance (ADC) scores, hand-written
// for Hopper (sm_90a).
//
// Replaces the gather-sum of the JAX package's batched PQ search,
// cleora_tpu/compress.py PQIndex.search_batch._adc (:149-159):
//
//   scores[q, i] = tables[q, 0, codes[i, 0]] + tables[q, 1, codes[i, 1]]
//                  + ... + tables[q, M-1, codes[i, M-1]]
//
// summed in float32 in m order, as the JAX loop adds (the first term is not
// added to a zero, so a -0.0 stays -0.0).  tables is float32 (Q, M, C), codes
// (N, M) uint8, uint16 or int32 (every code below C), scores float32 (Q, N).
// The (Q, M, C) tables (an einsum) and the top-k stay library calls.  The
// adds are __fadd_rn in the same order as ops/pq.py's pq_adc_plain, so the
// scores are bitwise equal to it.
//
// Bound on the card: bytes.  The (Q, N) scores are written once (8 GB at
// Q = 1,024 and N = 1.96 M) and dominate the codes (N·M bytes) and the
// tables read once.
//
// Design: a block of 256 threads takes a tile of up to 8 queries and
// stages the tile's tables (8 KiB per query at M = 8, C = 256) in shared
// memory once, then strides over its share of the rows, one row per thread
// at a time: the thread reads the row's M codes once and keeps the tile's 8
// sums in registers, so a warp writes 32 consecutive scores of a query row
// at a time.  The grid has a few waves of blocks, so each staged table
// serves thousands of rows (a block per 256 rows would move 8x more table
// bytes into shared memory than it writes scores).  When one query's
// tables exceed what shared memory holds, the gathers read them from
// global memory (through L2) instead.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;                  // queries per block
constexpr int64_t kStageBytes = 200 * 1024;  // of the 227 KB a block may use
constexpr int kWaves = 4;                 // resident-block waves per launch

template <typename CodeT>
__global__ void pq_adc_kernel(const float* __restrict__ tables,
                              const CodeT* __restrict__ codes,
                              float* __restrict__ scores, int64_t q,
                              int64_t n, int m, int c, int tile, bool staged) {
  extern __shared__ float stage[];
  const int64_t per_query = (int64_t)m * c;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q0 = (int64_t)blockIdx.y * tile; q0 < q;
       q0 += (int64_t)gridDim.y * tile) {
    const int nq = (int)(q - q0 < tile ? q - q0 : (int64_t)tile);
    const float* tab = tables + q0 * per_query;
    if (staged) {
      __syncthreads();  // the previous tile's gathers are done
      for (int64_t t = threadIdx.x; t < nq * per_query; t += blockDim.x)
        stage[t] = __ldg(tab + t);
      __syncthreads();
      tab = stage;
    }
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const CodeT* row = codes + i * m;
      float acc[kTile];
      const int64_t first = (int64_t)__ldg(row);
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        if (k < nq) acc[k] = tab[k * per_query + first];
      for (int mm = 1; mm < m; ++mm) {
        const int64_t at = (int64_t)mm * c + (int64_t)__ldg(row + mm);
#pragma unroll
        for (int k = 0; k < kTile; ++k)
          if (k < nq) acc[k] = __fadd_rn(acc[k], tab[k * per_query + at]);
      }
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        if (k < nq) scores[(q0 + k) * n + i] = acc[k];
    }
  }
}

template <typename CodeT>
int launch(const float* tables, const CodeT* codes, float* scores, int64_t q,
           int64_t n, int m, int c, cudaStream_t stream) {
  const int64_t per_query = (int64_t)m * c * (int64_t)sizeof(float);
  const bool staged = per_query <= kStageBytes;
  int tile = kTile;
  if (staged && per_query * tile > kStageBytes)
    tile = (int)(kStageBytes / per_query);
  if (tile > q) tile = (int)q;
  const size_t smem = staged ? (size_t)(per_query * tile) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pq_adc_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // a few waves of resident blocks in all, the query tiles on y
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, pq_adc_kernel<CodeT>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (q + tile - 1) / tile;
  const int64_t grid_y = tiles < 65535 ? tiles : 65535;
  const int64_t row_tiles = (n + kThreads - 1) / kThreads;
  int64_t grid_x = ((int64_t)kWaves * sms * (resident > 0 ? resident : 1) +
                    grid_y - 1) / grid_y;
  if (grid_x > row_tiles) grid_x = row_tiles;
  if (grid_x < 1) grid_x = 1;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  pq_adc_kernel<CodeT><<<grid, kThreads, smem, stream>>>(
      tables, codes, scores, q, n, m, c, tile, staged);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K13 on `stream` and returns a CUDA error code (0 on success).
// `code_bytes` is 1 (uint8), 2 (uint16) or 4 (int32).  The wrapper
// (kernels/__init__.py pq_adc) checks shapes; every code is checked to lie
// below C once, where the codes are uploaded (ops/pq.py device_codes).
extern "C" int pq_adc_launch(const float* tables, const void* codes,
                             int code_bytes, float* scores, int64_t q,
                             int64_t n, int m, int c, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 1:
      return launch(tables, static_cast<const uint8_t*>(codes), scores, q, n,
                    m, c, s);
    case 2:
      return launch(tables, static_cast<const uint16_t*>(codes), scores, q, n,
                    m, c, s);
    case 4:
      return launch(tables, static_cast<const int32_t*>(codes), scores, q, n,
                    m, c, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
