// K10: run-length reduction of a sorted key stream, hand-written for Hopper
// (sm_90a).
//
// Replaces the reduce half of the JAX package's counting programs,
// cleora_tpu/ops/cooccur.py _reduce_walks_sweep_impl (:236-254) and
// _sort_reduce (:46-71), which also serves every chain merge (_merge_impl,
// :339): after the sort, each run of equal keys becomes one
// (center, context, count) triple, and the triples of each hash partition
// are counted.
//
//   keys: ascending int64, key = ((cen % passes) * n + cen) * n + ctx, with
//         the dead key INT64_MAX (masked lanes) sorted to the end;
//   counts: int32 per key, or null for a count of 1 each (the sweep);
//   out:  cen[r], ctx[r], cnt[r] for the r-th run, exactly m runs, and
//         m_per[s] = the number of runs of partition s = key / n^2.
//
// Counts are summed modulo 2^32 into int32, as the JAX program's int32
// segment_sum wraps; ops/cooccur.py:_check_count_overflow catches the first
// wrap.
//
// Two kernels, with a prefix sum between them (torch.cumsum, a library
// call): run_heads marks each run's first key, the scan turns the marks into
// each run's output slot, and run_reduce lets the thread at a run head walk
// its run, sum the counts and write the triple.
//
// Bound on the card: bytes.  The keys (and counts) are read once and 12
// bytes are written per run; the marks and the scan add 12 bytes per key.
//
// Design: XLA computes the run ids with a cumsum and then scatters keys and
// a segment_sum of the counts into full-length buffers.  Here a run is summed
// by the one thread that owns its head, in registers, and written once into
// an exactly sized output; the per-partition counts are added in shared
// memory by each block and then once per block and partition into m_per.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int64_t kDead = INT64_MAX;

__global__ void run_heads_kernel(const int64_t* __restrict__ keys,
                                 int64_t len, int32_t* __restrict__ heads) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  const int64_t k = __ldg(keys + i);
  heads[i] = k != kDead && (i == 0 || __ldg(keys + i - 1) != k);
}

__global__ void run_reduce_kernel(const int64_t* __restrict__ keys,
                                  const int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ heads,
                                  const int32_t* __restrict__ pos, int64_t len,
                                  int64_t n, int passes,
                                  int32_t* __restrict__ cen,
                                  int32_t* __restrict__ ctx,
                                  int32_t* __restrict__ cnt,
                                  int32_t* __restrict__ m_per) {
  extern __shared__ int32_t block_m[];
  for (int s = threadIdx.x; s < passes; s += blockDim.x) block_m[s] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < len && __ldg(heads + i)) {
    const int64_t k = __ldg(keys + i);
    uint32_t sum = 0u;
    int64_t j = i;
    do {
      sum += counts ? (uint32_t)__ldg(counts + j) : 1u;
      ++j;
    } while (j < len && __ldg(keys + j) == k);
    const int64_t r = (int64_t)__ldg(pos + i) - 1;
    const int64_t nn = n * n;
    cen[r] = (int32_t)((k % nn) / n);
    ctx[r] = (int32_t)(k % n);
    cnt[r] = (int32_t)sum;
    atomicAdd(block_m + (int)(k / nn), 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < passes; s += blockDim.x)
    if (block_m[s]) atomicAdd(m_per + s, block_m[s]);
}

constexpr int kThreads = 256;

dim3 grid_for(int64_t len) {
  return dim3((unsigned)((len + kThreads - 1) / kThreads));
}

}  // namespace

// Launches run_heads on `stream` and returns cudaGetLastError().
extern "C" int run_length_heads_launch(const int64_t* keys, int64_t len,
                                       int32_t* heads, void* stream) {
  if (len > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    run_heads_kernel<<<grid_for(len), kThreads, 0, s>>>(keys, len, heads);
  }
  return (int)cudaGetLastError();
}

// Launches run_reduce on `stream` and returns cudaGetLastError().  `pos` is
// the inclusive prefix sum of `heads`; `counts` may be null; `m_per` holds
// `passes` zeroed int32 (passes <= 8192, checked by the Python wrapper).
extern "C" int run_length_launch(const int64_t* keys, const int32_t* counts,
                                 const int32_t* heads, const int32_t* pos,
                                 int64_t len, int64_t n, int passes,
                                 int32_t* cen, int32_t* ctx, int32_t* cnt,
                                 int32_t* m_per, void* stream) {
  if (len > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t shared = sizeof(int32_t) * (size_t)passes;
    run_reduce_kernel<<<grid_for(len), kThreads, shared, s>>>(
        keys, counts, heads, pos, len, n, passes, cen, ctx, cnt, m_per);
  }
  return (int)cudaGetLastError();
}
