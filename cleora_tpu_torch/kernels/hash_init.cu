// K3: the deterministic hash init on the card, hand-written for Hopper
// (sm_90a).
//
// Replaces the JAX package's cleora_tpu/ops/init.py device_init_rows (:60),
// the program each device runs to build its own rows of the initial state
// (cleora_tpu/parallel/state.py:126).  Bit for bit the reference's
// init_value (graph/hashing.py:init_embeddings):
//
//   s        = (uint64) h[i] + (uint64) (c + seed)          wrapping
//   m        = (int64) (s * FX_K)                            wrapping
//   out[i,c] = (float) (m % 2^23) / 2^23                     C's truncated %
//
// The TPU has no 64-bit integers, so the JAX version emulates the add and the
// multiply on (hi, lo) pairs of 32-bit lanes.  Here they are native
// `unsigned long long` operations.  The remainder fits in 24 bits, so the
// float conversion is exact, and dividing by a power of two is exact: every
// value equals the host's.
//
// Bound on the card: bytes.  A call reads the N hashes (8 N B) and writes
// the N x D float32 output (4 N D B); the few integer operations per value
// are far below the card's rate.
//
// Design: one thread per four neighbouring output columns of one row,
// stored as one float4 when D % 4 == 0 and the output is 16-byte aligned
// (the wrapper allocates it, so it always is), one value at a time
// otherwise.  Neighbouring threads write neighbouring 16-byte groups.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kFxK = 0x517CC1B727220A95ull;
constexpr long long kMaxHash = 1ll << 23;

__device__ __forceinline__ float init_value(unsigned long long h,
                                            unsigned long long offset) {
  const unsigned long long m = (h + offset) * kFxK;
  const long long rem = static_cast<long long>(m) % kMaxHash;
  return static_cast<float>(rem) / static_cast<float>(kMaxHash);
}

__global__ void hash_init_vec4(const int64_t* __restrict__ hashes,
                               float* __restrict__ out, int64_t n_rows,
                               int64_t d, int64_t seed) {
  const int64_t groups = d >> 2;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rows * groups) return;
  const int64_t row = t / groups;
  const int64_t c = (t - row * groups) << 2;
  const unsigned long long h = static_cast<unsigned long long>(hashes[row]);
  const unsigned long long off =
      static_cast<unsigned long long>(c) + static_cast<unsigned long long>(seed);
  float4 v;
  v.x = init_value(h, off);
  v.y = init_value(h, off + 1ull);
  v.z = init_value(h, off + 2ull);
  v.w = init_value(h, off + 3ull);
  *reinterpret_cast<float4*>(out + row * d + c) = v;
}

__global__ void hash_init_scalar(const int64_t* __restrict__ hashes,
                                 float* __restrict__ out, int64_t n_rows,
                                 int64_t d, int64_t seed) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rows * d) return;
  const int64_t row = t / d;
  const int64_t c = t - row * d;
  out[t] = init_value(static_cast<unsigned long long>(hashes[row]),
                      static_cast<unsigned long long>(c) +
                          static_cast<unsigned long long>(seed));
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError().  `seed` is added
// to the column index with two's-complement wrapping, as the host's int64
// arithmetic does.  `vec4` requires d % 4 == 0 and out 16-byte aligned
// (checked by the Python wrapper).
extern "C" int hash_init_launch(const int64_t* hashes, float* out,
                                int64_t n_rows, int64_t d, int64_t seed,
                                int vec4, void* stream) {
  if (n_rows > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    const int64_t work = vec4 ? n_rows * (d / 4) : n_rows * d;
    const dim3 grid((unsigned)((work + threads - 1) / threads));
    if (vec4) {
      hash_init_vec4<<<grid, threads, 0, s>>>(hashes, out, n_rows, d, seed);
    } else {
      hash_init_scalar<<<grid, threads, 0, s>>>(hashes, out, n_rows, d, seed);
    }
  }
  return (int)cudaGetLastError();
}
