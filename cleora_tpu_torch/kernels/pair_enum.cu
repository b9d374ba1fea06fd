// K9: windowed symmetric pair enumeration, hand-written for Hopper (sm_90a).
//
// Replaces the enumerate half of the JAX package's single-sweep counting
// reduce, cleora_tpu/ops/cooccur.py _reduce_walks_sweep_impl (:196-254):
// for every offset o = 1 .. min(window, L-1) and every walk row b < n_valid,
// the pairs (a, c) = (walks[b, j], walks[b, j+o]) in both directions, each
// packed into one int64 sort key
//
//   key(cen, ctx) = ((cen % passes) * n + cen) * n + ctx
//
// so that one ascending sort orders the pairs by hash partition, then
// center, then context.  A pair with a sentinel or dead-end end (>= n), or
// from a row at or past n_valid, writes INT64_MAX.  The JAX program sorts two
// int32 lanes (key, ctx) instead, which needs passes * n < 2^31; the int64
// key is exact while passes * n^2 < 2^63 (checked by the wrapper).
//
// Output layout, the JAX program's concatenation order: for each offset o a
// segment of 2 * B * (L-o) keys, first the (a -> c) direction over the
// (B, L-o) window positions in row-major order, then (c -> a) over the same.
//
// Bound on the card: bytes.  The walks are read (4 B L) and 8 bytes are
// written per pair lane; a few integer operations per key.
//
// Design: one thread per window position (b, j) of one offset writes both
// directions' keys; neighbouring threads read neighbouring walk entries and
// write neighbouring keys.  The offset of a thread is found by walking the
// (at most `window`) segment lengths.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int64_t kDead = INT64_MAX;

__global__ void pair_enum_kernel(const int32_t* __restrict__ walks,
                                 int64_t batch, int walk_length,
                                 int64_t n_valid, int64_t n, int64_t passes,
                                 int window, int64_t positions,
                                 int64_t* __restrict__ keys) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= positions) return;
  // find the offset o whose segment holds position i
  int64_t rest = i, seg_start = 0;
  int o = 1;
  for (; o < window; ++o) {
    const int64_t len = batch * (walk_length - o);
    if (rest < len) break;
    rest -= len;
    seg_start += 2 * len;
  }
  const int64_t width = walk_length - o;
  const int64_t len = batch * width;
  const int64_t b = rest / width, j = rest - b * width;
  const int64_t a = __ldg(walks + b * walk_length + j);
  const int64_t c = __ldg(walks + b * walk_length + j + o);
  const bool ok = b < n_valid && a >= 0 && a < n && c >= 0 && c < n;
  keys[seg_start + rest] = ok ? ((a % passes) * n + a) * n + c : kDead;
  keys[seg_start + len + rest] = ok ? ((c % passes) * n + c) * n + a : kDead;
}

}  // namespace

// Launches K9 on `stream` and returns cudaGetLastError().  `window` is
// already min(window, walk_length - 1) >= 1; `keys` holds
// 2 * batch * sum_{o=1..window} (walk_length - o) int64.
extern "C" int pair_enum_launch(const int32_t* walks, int64_t batch,
                                int walk_length, int64_t n_valid, int64_t n,
                                int64_t passes, int window, int64_t* keys,
                                void* stream) {
  if (batch > 0 && window > 0) {
    int64_t positions = 0;
    for (int o = 1; o <= window; ++o) positions += batch * (walk_length - o);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    const dim3 grid((unsigned)((positions + threads - 1) / threads));
    pair_enum_kernel<<<grid, threads, 0, s>>>(walks, batch, walk_length,
                                              n_valid, n, passes, window,
                                              positions, keys);
  }
  return (int)cudaGetLastError();
}
