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
// (N, M) uint8, uint16 or int32 (every code below C), scores float32 (Q, N)
// in rows of a stride `ld`, a multiple of 32 floats (the wrapper fills the
// columns N .. ld with -inf, so that a top-k over the whole rows, which are
// contiguous, never takes them while k <= N).  The (Q, M, C) tables (an
// einsum) and the top-k stay library calls.  The adds are __fadd_rn in the
// same order as ops/pq.py's pq_adc_plain, so the scores are bitwise equal
// to it.
//
// Bound on the card: bytes.  The (Q, N) scores are written once (8 GB at
// Q = 1,024 and N = 1.96 M) and dominate the codes (N·M bytes) and the
// tables read once.  Next to it: 16 G table reads from shared memory at
// that shape (Q·N·M words, 128 bytes a cycle an SM).
//
// Design.  The queries are cut into tiles of kQt = 16, 8 or 4 in order (the
// wrapper, kernels.pq_tile_width, takes the narrowest that holds Q, and
// narrows it while a tile's tables do not fit in shared memory).  A lane
// takes 4 queries of a row, kL = kQt/4 lanes a row, so a warp takes
// kRows = 32/kL rows at a time; every load of a warp is free of bank
// conflicts, whatever the codes:
//   * the tables come re-laid by the wrapper (kernels.pq_lane_tables) as
//     (tiles, ceil(M/kS), C, kS, kQt): the kQt queries of a tile side by
//     side, kS = 32/kQt subspaces in the kS parts of a 128-byte line, so
//     subspace m lies in part m % kS of the banks;
//   * a 16-byte load is served a quarter-warp (8 lanes, kS rows) at a
//     time, and row j of a quarter runs j subspaces behind the quarter's
//     first: at each load the kS rows read kS consecutive subspaces, in the
//     kS different parts of the banks, where the row-a-lane form this
//     replaced had 32 lanes at random banks (about 3.5 wavefronts a load).
//     Across a lane's 4 rows of a run the lag costs kS - 1 loads in 4·M;
//   * each lane adds in m order from -0.0 (-0.0 + x is x for every x, so
//     the first term is not changed), one 16-byte load and 4 adds a term;
//   * where a row's M codes fill 8 bytes of uint8 (M = 8, the corpus's),
//     they are one 8-byte load, a broadcast to the row's lanes, rotated
//     by j codes for row j of a quarter, so a load's code sits at the same
//     place in every row's word and a term's address takes 2 instructions;
//     other codes are read one at a time;
//   * a block stages a tile's tables in shared memory (8 KiB a query at
//     M = 8, C = 256: 128 KiB a tile of 16) and keeps them for a
//     contiguous run of work items (tile, chunk of rows), so a block stages
//     at most a few tiles in all; a grid of resident blocks takes equal
//     shares of the items, and a block's warps take consecutive runs of
//     4·kRows rows;
//   * the scores leave the lanes' registers as they are: a store of a warp
//     is kRows consecutive rows of 4·kL query rows, each a whole number of
//     32-byte sectors, since a row of the scores starts on a 128-byte line
//     (ld) and a run on a multiple of 32 rows.
// scripts/torch_k8_k13_probe.py measured the forms on an H100 at Q = 1,024,
// N = 1,958,363, M = 8 (the form it replaces: 8.8 ms): a lane a query with
// a 4-byte load a term, 11.9 ms; tiles of 16 with the odd row of a quarter
// reading a pair of subspaces in the other order, put back by selects,
// 12.3 ms (about 6.5 instructions a term); the lag over unpadded rows of
// the scores (a warp's store of a query row beginning mid-line), 11.3 ms,
// and over rows padded to 32 floats 3.65 ms; a padded shared-memory
// transpose for 128-byte stores of 32 rows a query row, 5.7 ms against 3.7
// for the stores from registers (streaming stores 4.5; 256 threads a
// block 7.2).  When a tile's tables exceed shared memory the loads read
// the same layout from global memory (through L2).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;            // a block
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;                // rows a lane's run

template <int kQt>
struct Tile {
  static constexpr int kL = kQt / 4;       // lanes a row, 4 queries a lane
  static constexpr int kRows = 32 / kL;    // rows a warp takes at a time
  static constexpr int kS = 8 / kL;        // subspaces a line, rows a quarter
  static constexpr int kRun = kSteps * kRows;  // rows a warp's run
};

__device__ __forceinline__ float4 add4(float4 a, const float4 b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
  return a;
}

// The byte offset, in a tile's lines, of code 0 of subspace m for the 4
// queries of lane quad `quad`.
template <int kQt>
__device__ __forceinline__ uint32_t subspace_offset(int m, int c, int quad) {
  constexpr int kS = Tile<kQt>::kS;
  return (uint32_t)(((m / kS) * c * 32 + (m % kS) * kQt + 4 * quad) * 4);
}

__device__ __forceinline__ float4 load4(const char* base, uint32_t at) {
  return *reinterpret_cast<const float4*>(base + at);
}

// Byte r (static) of a row's packed code word (lo, hi).
__device__ __forceinline__ uint32_t field(uint32_t lo, uint32_t hi, int r) {
  return __byte_perm(r < 4 ? lo : hi, 0u, 0x4440u | (uint32_t)(r & 3));
}

// A lane's scores of its kSteps rows of the run at r0 (rows r0 + kRows·k +
// group) where a row's 8 codes are the bytes of one 8-byte word.  Load t
// reads subspace (t - lag) % 8 of row step (t - lag) / 8; off[r] is the
// lane's offset of load t's subspace, r = t % 8, and the row's words are
// rotated by `lag` codes, so that code is byte r of its word.
template <int kQt>
__device__ __forceinline__ void run_packed(float4 (&acc)[kSteps],
                                           const char* base,
                                           const uint8_t* codes, int64_t r0,
                                           int64_t n, int group, int lag,
                                           const uint32_t* off) {
  constexpr int kM = 8, kS = Tile<kQt>::kS, kRows = Tile<kQt>::kRows;
  uint32_t lo[kSteps], hi[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int64_t i = r0 + kRows * k + group;
    uint64_t w = __ldg(reinterpret_cast<const unsigned long long*>(codes) +
                       (i < n ? i : n - 1));
    if (lag) w = (w << (8 * lag)) | (w >> (64 - 8 * lag));
    lo[k] = (uint32_t)w;
    hi[k] = (uint32_t)(w >> 32);
    acc[k] = make_float4(-0.0f, -0.0f, -0.0f, -0.0f);
  }
#pragma unroll
  for (int t = 0; t < kSteps * kM + kS - 1; ++t) {
    const int r = t % kM;
    const int ka = t / kM, kb = ka - 1;  // the row step at r >= lag, r < lag
    const bool now = r >= lag;           // this row is at step ka
    uint32_t wl, wh;
    if (ka >= kSteps) {
      wl = lo[kb], wh = hi[kb];
    } else if (kb < 0) {
      wl = lo[ka], wh = hi[ka];
    } else {
      wl = now ? lo[ka] : lo[kb];
      wh = now ? hi[ka] : hi[kb];
    }
    const float4 x = load4(base, off[r] + field(wl, wh, r) * 128u);
    if (ka >= kSteps) {
      if (!now) acc[kb] = add4(acc[kb], x);
    } else if (kb < 0) {
      if (now) acc[ka] = add4(acc[ka], x);
    } else if (now) {
      acc[ka] = add4(acc[ka], x);
    } else {
      acc[kb] = add4(acc[kb], x);
    }
  }
}

// The same for any M and codes read one at a time: each row in turn, the
// row of lag j a quarter j subspaces behind.
template <int kQt, typename CodeT>
__device__ __forceinline__ void run_codes(float4 (&acc)[kSteps],
                                          const char* base,
                                          const CodeT* codes, int64_t r0,
                                          int64_t n, int m, int c, int group,
                                          int quad, int lag) {
  constexpr int kS = Tile<kQt>::kS, kRows = Tile<kQt>::kRows;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int64_t i = r0 + kRows * k + group;
    const CodeT* row = codes + (i < n ? i : n - 1) * m;
    float4 a = make_float4(-0.0f, -0.0f, -0.0f, -0.0f);
    for (int t = 0; t < m + kS - 1; ++t) {
      const int mm = t - lag;
      if (mm >= 0 && mm < m) {
        const uint32_t code = (uint32_t)__ldg(row + mm);
        a = add4(a, load4(base,
                          subspace_offset<kQt>(mm, c, quad) + code * 128u));
      }
    }
    acc[k] = a;
  }
}

template <int kQt, typename CodeT, bool kStaged, bool kPacked>
__global__ void __launch_bounds__(kThreads, 1) pq_adc_kernel(
    const float* __restrict__ tables, const CodeT* __restrict__ codes,
    float* __restrict__ scores, int64_t ld, int64_t q, int64_t n, int m,
    int c, int64_t chunks, int64_t chunk_runs, int64_t items) {
  using T = Tile<kQt>;
  extern __shared__ __align__(16) float smem[];
  const int64_t tile_words = (int64_t)((m + T::kS - 1) / T::kS) * c * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / T::kL, quad = lane % T::kL;
  const int lag = group % T::kS;
  uint32_t off[8];
  if constexpr (kPacked) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      off[r] = subspace_offset<kQt>((r + 8 - lag) % 8, c, quad);
  }
  const int64_t lo = items * blockIdx.x / gridDim.x;
  const int64_t hi = items * (blockIdx.x + 1) / gridDim.x;
  const int64_t runs = (n + T::kRun - 1) / T::kRun;
  int64_t staged = -1;
  for (int64_t it = lo; it < hi; ++it) {
    const int64_t tile = it / chunks, chunk = it % chunks;
    const char* base =
        reinterpret_cast<const char*>(tables + tile * tile_words);
    if constexpr (kStaged) {
      if (tile != staged) {
        __syncthreads();  // the previous tile's reads are done
        const float4* src = reinterpret_cast<const float4*>(base);
        float4* dst = reinterpret_cast<float4*>(smem);
        for (int64_t t = threadIdx.x; t < tile_words / 4; t += kThreads)
          dst[t] = __ldg(src + t);
        __syncthreads();
        staged = tile;
      }
      base = reinterpret_cast<const char*>(smem);
    }
    const int64_t q0 = tile * kQt + 4 * quad;  // the lane's first query
    const int64_t run_end = (chunk + 1) * chunk_runs < runs
                                ? (chunk + 1) * chunk_runs
                                : runs;
    for (int64_t run = chunk * chunk_runs + warp; run < run_end;
         run += kWarps) {
      const int64_t r0 = run * T::kRun;
      float4 acc[kSteps];
      if constexpr (kPacked)
        run_packed<kQt>(acc, base, codes, r0, n, group, lag, off);
      else
        run_codes<kQt>(acc, base, codes, r0, n, m, c, group, quad, lag);
      // a store of the warp: kRows consecutive rows of each of 4·kL query
      // rows, whole 32-byte sectors (ld and r0 are multiples of 32)
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const int64_t i = r0 + T::kRows * k + group;
        const float v[4] = {acc[k].x, acc[k].y, acc[k].z, acc[k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (q0 + e < q && i < n) scores[(q0 + e) * ld + i] = v[e];
      }
    }
  }
}

template <int kQt, typename CodeT, bool kStaged, bool kPacked>
int launch_form(const float* tables, const CodeT* codes, float* scores,
                int64_t ld, int64_t q, int64_t n, int m, int c, size_t smem,
                cudaStream_t stream) {
  auto kernel = pq_adc_kernel<kQt, CodeT, kStaged, kPacked>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, sms = 0, resident = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // the runs of a tile cut into as many chunks as resident blocks, the
  // items (tile, chunk) tile-major in equal shares of the grid
  const int64_t blocks = (int64_t)sms * (resident > 0 ? resident : 1);
  const int64_t tiles = (q + kQt - 1) / kQt;
  const int64_t runs = (n + Tile<kQt>::kRun - 1) / Tile<kQt>::kRun;
  int64_t chunks = (runs + kWarps - 1) / kWarps;
  if (chunks > blocks) chunks = blocks;
  const int64_t chunk_runs = (runs + chunks - 1) / chunks;
  chunks = (runs + chunk_runs - 1) / chunk_runs;
  const int64_t items = tiles * chunks;
  const int64_t grid = items < blocks ? items : blocks;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      tables, codes, scores, ld, q, n, m, c, chunks, chunk_runs, items);
  return (int)cudaGetLastError();
}

template <int kQt, typename CodeT>
int launch(const float* tables, const CodeT* codes, float* scores, int64_t ld,
           int64_t q, int64_t n, int m, int c, cudaStream_t stream) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  constexpr int kS = Tile<kQt>::kS;
  const size_t tile = (size_t)((m + kS - 1) / kS) * c * 32 * sizeof(float);
  const bool staged = tile <= (size_t)optin;
  const size_t smem = staged ? tile : 0;
  if constexpr (sizeof(CodeT) == 1) {
    if (m == 8 && reinterpret_cast<uintptr_t>(codes) % 8 == 0) {
      return staged ? launch_form<kQt, CodeT, true, true>(
                          tables, codes, scores, ld, q, n, m, c, smem, stream)
                    : launch_form<kQt, CodeT, false, true>(
                          tables, codes, scores, ld, q, n, m, c, smem,
                          stream);
    }
  }
  return staged ? launch_form<kQt, CodeT, true, false>(
                      tables, codes, scores, ld, q, n, m, c, smem, stream)
                : launch_form<kQt, CodeT, false, false>(
                      tables, codes, scores, ld, q, n, m, c, smem, stream);
}

template <typename CodeT>
int launch_tile(int qt, const float* tables, const CodeT* codes,
                float* scores, int64_t ld, int64_t q, int64_t n, int m, int c,
                cudaStream_t stream) {
  switch (qt) {
    case 16:
      return launch<16>(tables, codes, scores, ld, q, n, m, c, stream);
    case 8:
      return launch<8>(tables, codes, scores, ld, q, n, m, c, stream);
    case 4:
      return launch<4>(tables, codes, scores, ld, q, n, m, c, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches K13 on `stream` and returns a CUDA error code (0 on success).
// `tables` is the (ceil(q/qt), ceil(M/kS), C, kS, qt) float32 layout of
// kernels.pq_lane_tables, kS = 32/qt, 16-byte aligned; `qt` is 16, 8 or 4;
// `code_bytes` is 1 (uint8), 2 (uint16) or 4 (int32); `scores` holds q rows
// of `ld` floats, a multiple of 32 and at least n, 128-byte aligned, of
// which the first n are written.  The wrapper (kernels/__init__.py
// pq_adc_rows) checks shapes; every code is checked to lie below C once,
// where the codes are uploaded (ops/pq.py device_codes).
extern "C" int pq_adc_launch(const float* tables, int qt, const void* codes,
                             int code_bytes, float* scores, int64_t ld,
                             int64_t q, int64_t n, int m, int c,
                             void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaGetLastError();
  if (ld % 32 != 0 || ld < n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 1:
      return launch_tile(qt, tables, static_cast<const uint8_t*>(codes),
                         scores, ld, q, n, m, c, s);
    case 2:
      return launch_tile(qt, tables, static_cast<const uint16_t*>(codes),
                         scores, ld, q, n, m, c, s);
    case 4:
      return launch_tile(qt, tables, static_cast<const int32_t*>(codes),
                         scores, ld, q, n, m, c, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
