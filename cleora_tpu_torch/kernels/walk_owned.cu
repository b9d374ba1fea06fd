// K17: one owner-routed hop of the first-order walks over row-sharded walk
// tables, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's sharded-table walk engine
// cleora_tpu/algorithms.py _device_walk_sharded_jit (:1380), whose scan body
// computes each hop on the device that owns the lane's current row and
// psums the disjoint contributions.  Rank r holds rows
// [row_lo, row_lo + rps) of the self-loop-free walk CSR with indptr local to
// its own cols slice (ops/walk.py walk_table_slice).  For lane b at node
// cur = frontier[b]:
//
//   owned (row_lo <= cur < row_lo + rps, cur < n), deg > 0:
//       out[b] = cols[indptr[cur - row_lo] + min(int(u * float(d)), d - 1)]
//   owned, deg == 0:         out[b] = n   (a dead end)
//   cur outside [0, n):      out[b] = n on the root rank, 0 elsewhere
//   otherwise:               out[b] = 0
//
// so that the sum over the ranks (one all-reduce of the (B,) int32 row) is
// exactly K8's hop: each lane has one nonzero contributor.  The uniform u of
// hop h of walk g = base + b is K8's: (x0 >> 8) * 2^-24 of Philox4x32-10 at
// counter (g & 0xffffffff, g >> 32, h, 0) under key (seed lo, seed hi), and
// the product is one round-to-nearest float32 multiply, so the walks are
// bitwise K8's at every rank count.
//
// Bound on the card: bytes, in 32-byte sectors, as K8's.  An owned lane
// makes three dependent random reads (deg, indptr, cols), each of which
// moves a sector; every lane reads its frontier entry and writes one int32.
//
// Design: one thread per lane, one launch per hop (each hop waits on the
// collective), the Philox draw only for the lanes the rank owns.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

// The first output word of Philox4x32-10 at counter (c0, c1, c2, 0).
__device__ __forceinline__ uint32_t philox_x0(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t k0,
                                              uint32_t k1) {
  uint32_t c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c1 = lo1;
    c3 = lo0;
    c0 = n0;
    c2 = n2;
  }
  return c0;
}

__global__ void walk_owned_kernel(const int32_t* __restrict__ indptr,
                                  const int32_t* __restrict__ cols,
                                  const int32_t* __restrict__ deg,
                                  const int32_t* __restrict__ frontier,
                                  int32_t* __restrict__ out, int64_t batch,
                                  int hop, int64_t base, uint32_t k0,
                                  uint32_t k1, int32_t n, int64_t row_lo,
                                  int64_t rps, int root) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int32_t cur = __ldg(frontier + b);
  int32_t share = 0;
  if (cur >= 0 && cur < n) {
    const int64_t lr = (int64_t)cur - row_lo;
    if (lr >= 0 && lr < rps) {
      share = n;
      const int32_t d = __ldg(deg + lr);
      if (d > 0) {
        const uint64_t g = (uint64_t)(base + b);
        const uint32_t bits =
            philox_x0((uint32_t)g, (uint32_t)(g >> 32), (uint32_t)hop, k0, k1);
        const float u = __uint2float_rn(bits >> 8) * 5.9604644775390625e-08f;
        int32_t t = (int32_t)__fmul_rn(u, __int2float_rn(d));
        if (t > d - 1) t = d - 1;
        share = __ldg(cols + __ldg(indptr + lr) + t);
      }
    }
  } else if (root) {
    share = n;
  }
  out[b] = share;
}

}  // namespace

// Launches K17 on `stream` and returns cudaGetLastError().  `frontier` and
// `out` are (batch,) int32; the slice (rps rows, local offsets) is
// validated once when it is built (ops/walk.py ShardedWalkTables).
extern "C" int walk_owned_launch(const int32_t* indptr, const int32_t* cols,
                                 const int32_t* deg, const int32_t* frontier,
                                 int32_t* out, int64_t batch, int hop,
                                 int64_t base, uint32_t k0, uint32_t k1,
                                 int32_t n, int64_t row_lo, int64_t rps,
                                 int root, void* stream) {
  if (batch > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    const dim3 grid((unsigned)((batch + threads - 1) / threads));
    walk_owned_kernel<<<grid, threads, 0, s>>>(indptr, cols, deg, frontier,
                                               out, batch, hop, base, k0, k1,
                                               n, row_lo, rps, root);
  }
  return (int)cudaGetLastError();
}
