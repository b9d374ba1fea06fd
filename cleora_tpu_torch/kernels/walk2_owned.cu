// K18: the owner-routed stages of the second-order (Node2Vec p/q) walk over
// row-sharded weighted walk tables, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's sharded-table second-order engine
// cleora_tpu/algorithms.py _device_walk2_sharded_jit (:1574).  Rank r holds
// rows [row_lo, row_lo + rps) of the weighted walk CSR (indptr local to its
// cols/vals slice, deg, wmax, wsum; ops/walk.py walk_table_slice).  A hop of
// K12 (kernels/walk_p_q.cu) is cut where it reads a row another rank may
// own, and each owner-stage writes its values for the lanes it owns and 0
// for the others, so that one all-reduce (SUM, int32; a float travels by
// its bits) of each stage's buffer has exactly one nonzero term per lane:
//
//   stats   (owner of cur, every lane):   d, wmax, wsum, w_bt
//           w_bt = vals[pos(prev in row cur)] * inv_p, 0 without prev
//   pending (replicated):                 d > 0 and not dead,
//           dead = wsum * m2 + w_bt < 1e-15, m2 = max(1, inv_q)
//   per rejection round r over the pending lanes:
//   propose (owner of cur): unless the lane takes the backtrack edge
//           (not first and u0 < pi, pi = w_bt / max(env, 1e-30),
//           env = w_bt + (float(d) * wmax) * m2), the proposal
//           x = cols[indptr[cur] + min(int(u1 * float(d)), d - 1)], w = vals[..]
//   member  (owner of prev): 1 when x is in prev's row, for the lanes that
//           test it (not first, not backtrack, x != prev, r < tries - 1)
//   decide  (replicated): backtrack -> prev; first hop or last round -> x;
//           else accept x when u2 < (w * alpha) / max(wmax * m2, 1e-30),
//           alpha = 0 for x == prev, 1 for a common neighbour, inv_q
//           otherwise; the lanes that reject stay pending.
//
// The uniforms of round r of hop h of walk g = base + lane are K12's:
// x0, x1, x2 of Philox4x32-10 at counter (g lo, g hi, h, r + 1) under key
// (seed lo, seed hi), each (x >> 8) * 2^-24; every float operation is a
// round-to-nearest intrinsic in K12's order.  Every rank takes the same
// decisions from the same summed values, so the walks are bitwise K12's at
// every batch size and rank count.
//
// Bound on the card: bytes, in 32-byte sectors: the random reads of deg,
// indptr, wmax, wsum and the binary searches in cur's and prev's rows, as
// K12's; each stage also reads and writes its (B,)-sized buffers once.
//
// Design: one thread per lane in every stage.  The stages are separate
// launches because each waits on a collective; the host compacts the
// pending lanes between rounds (torch.nonzero keeps them in order, so the
// ranks' buffers line up).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

// Philox4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1): x[0..3].
__device__ __forceinline__ void philox4(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0, uint32_t k1,
                                        uint32_t x[4]) {
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
  x[0] = c0;
  x[1] = c1;
  x[2] = c2;
  x[3] = c3;
}

__device__ __forceinline__ float unit_float(uint32_t w) {
  return __uint2float_rn(w >> 8) * 5.9604644775390625e-08f;
}

// First position in [lo, hi) whose column is >= x (hi when none).
__device__ __forceinline__ int32_t lower_bound(const int32_t* __restrict__ cols,
                                               int32_t lo, int32_t hi,
                                               int32_t x) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(cols + mid) < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The local row of global node `v`, or -1 when this rank does not own it.
__device__ __forceinline__ int64_t local_row(int32_t v, int32_t n,
                                             int64_t row_lo, int64_t rps) {
  if (v < 0 || v >= n) return -1;
  const int64_t lr = (int64_t)v - row_lo;
  return (lr >= 0 && lr < rps) ? lr : -1;
}

// The replicated terms of one rejection round of lane `lane` (walk base +
// lane), from the summed stats (4 rows of `stride` int32).
struct Round {
  float u1, u2, cap;
  int32_t d, prev;
  bool first, is_bt;
};

__device__ __forceinline__ Round round_terms(const int32_t* __restrict__ stats,
                                             int64_t stride, int64_t lane,
                                             const int32_t* __restrict__ prev,
                                             int hop, int rnd, int64_t base,
                                             uint32_t k0, uint32_t k1,
                                             int32_t n, float inv_q) {
  Round t;
  const float m2 = fmaxf(1.0f, inv_q);
  t.d = __ldg(stats + lane);
  const float wm = __int_as_float(__ldg(stats + stride + lane));
  const float w_bt = __int_as_float(__ldg(stats + 3 * stride + lane));
  const float env =
      __fadd_rn(w_bt, __fmul_rn(__fmul_rn(__int2float_rn(t.d), wm), m2));
  const float pi = __fdiv_rn(w_bt, fmaxf(env, 1e-30f));
  t.cap = fmaxf(__fmul_rn(wm, m2), 1e-30f);
  t.prev = __ldg(prev + lane);
  t.first = !(t.prev >= 0 && t.prev < n);
  const uint64_t g = (uint64_t)(base + lane);
  uint32_t x[4];
  philox4((uint32_t)g, (uint32_t)(g >> 32), (uint32_t)hop, (uint32_t)(rnd + 1),
          k0, k1, x);
  t.is_bt = !t.first && unit_float(x[0]) < pi;
  t.u1 = unit_float(x[1]);
  t.u2 = unit_float(x[2]);
  return t;
}

__global__ void stats_kernel(const int32_t* __restrict__ indptr,
                             const int32_t* __restrict__ cols,
                             const float* __restrict__ vals,
                             const int32_t* __restrict__ deg,
                             const float* __restrict__ wmax,
                             const float* __restrict__ wsum,
                             const int32_t* __restrict__ cur,
                             const int32_t* __restrict__ prev,
                             int32_t* __restrict__ out, int64_t batch,
                             int32_t n, int64_t row_lo, int64_t rps,
                             float inv_p) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  int32_t d = 0;
  float wm = 0.0f, ws = 0.0f, w_bt = 0.0f;
  const int64_t lr = local_row(__ldg(cur + b), n, row_lo, rps);
  if (lr >= 0) {
    d = __ldg(deg + lr);
    wm = __ldg(wmax + lr);
    ws = __ldg(wsum + lr);
    const int32_t p = __ldg(prev + b);
    if (p >= 0 && p < n) {
      const int32_t lo = __ldg(indptr + lr);
      const int32_t pos = lower_bound(cols, lo, lo + d, p);
      if (pos < lo + d && __ldg(cols + pos) == p)
        w_bt = __fmul_rn(__ldg(vals + pos), inv_p);
    }
  }
  out[b] = d;
  out[batch + b] = __float_as_int(wm);
  out[2 * batch + b] = __float_as_int(ws);
  out[3 * batch + b] = __float_as_int(w_bt);
}

__global__ void pending_kernel(const int32_t* __restrict__ stats,
                               uint8_t* __restrict__ mask, int64_t batch,
                               float inv_q) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const float m2 = fmaxf(1.0f, inv_q);
  const float ws = __int_as_float(__ldg(stats + 2 * batch + b));
  const float w_bt = __int_as_float(__ldg(stats + 3 * batch + b));
  const bool dead = __fadd_rn(__fmul_rn(ws, m2), w_bt) < 1e-15f;
  mask[b] = (__ldg(stats + b) > 0 && !dead) ? 1 : 0;
}

__global__ void propose_kernel(const int32_t* __restrict__ indptr,
                               const int32_t* __restrict__ cols,
                               const float* __restrict__ vals,
                               const int32_t* __restrict__ stats,
                               int64_t batch,
                               const int64_t* __restrict__ lanes,
                               int64_t count,
                               const int32_t* __restrict__ cur,
                               const int32_t* __restrict__ prev, int hop,
                               int rnd, int64_t base, uint32_t k0,
                               uint32_t k1, int32_t n, int64_t row_lo,
                               int64_t rps, float inv_q,
                               int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int64_t lane = __ldg(lanes + i);
  int32_t x = 0, w = 0;
  const int64_t lr = local_row(__ldg(cur + lane), n, row_lo, rps);
  if (lr >= 0) {
    const Round t = round_terms(stats, batch, lane, prev, hop, rnd, base, k0,
                                k1, n, inv_q);
    if (!t.is_bt) {
      int32_t j = (int32_t)__fmul_rn(t.u1, __int2float_rn(t.d));
      if (j > t.d - 1) j = t.d - 1;
      const int32_t e = __ldg(indptr + lr) + j;
      x = __ldg(cols + e);
      w = __float_as_int(__ldg(vals + e));
    }
  }
  out[i] = x;
  out[count + i] = w;
}

__global__ void member_kernel(const int32_t* __restrict__ indptr,
                              const int32_t* __restrict__ cols,
                              const int32_t* __restrict__ deg,
                              const int32_t* __restrict__ stats,
                              int64_t batch,
                              const int64_t* __restrict__ lanes,
                              int64_t count, const int32_t* __restrict__ prop,
                              const int32_t* __restrict__ prev, int hop,
                              int rnd, int tries, int64_t base, uint32_t k0,
                              uint32_t k1, int32_t n, int64_t row_lo,
                              int64_t rps, float inv_q,
                              int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int64_t lane = __ldg(lanes + i);
  int32_t hit = 0;
  const int32_t p = __ldg(prev + lane);
  const int64_t lr = local_row(p, n, row_lo, rps);
  const int32_t x = __ldg(prop + i);
  if (lr >= 0 && x != p && rnd < tries - 1) {
    const Round t = round_terms(stats, batch, lane, prev, hop, rnd, base, k0,
                                k1, n, inv_q);
    if (!t.is_bt) {
      const int32_t lo = __ldg(indptr + lr);
      const int32_t hi = lo + __ldg(deg + lr);
      const int32_t pos = lower_bound(cols, lo, hi, x);
      hit = (pos < hi && __ldg(cols + pos) == x) ? 1 : 0;
    }
  }
  out[i] = hit;
}

__global__ void decide_kernel(const int32_t* __restrict__ stats,
                              int64_t batch,
                              const int64_t* __restrict__ lanes,
                              int64_t count, const int32_t* __restrict__ prop,
                              const int32_t* __restrict__ member,
                              const int32_t* __restrict__ prev, int hop,
                              int rnd, int tries, int64_t base, uint32_t k0,
                              uint32_t k1, int32_t n, float inv_q,
                              int32_t* __restrict__ nxt,
                              uint8_t* __restrict__ still) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int64_t lane = __ldg(lanes + i);
  const Round t = round_terms(stats, batch, lane, prev, hop, rnd, base, k0,
                              k1, n, inv_q);
  const int32_t x = __ldg(prop + i);
  bool hit = true;
  if (t.is_bt) {
    nxt[lane] = t.prev;
  } else if (t.first || rnd == tries - 1) {
    nxt[lane] = x;
  } else {
    const float alpha =
        x == t.prev ? 0.0f : (__ldg(member + i) != 0 ? 1.0f : inv_q);
    const float w = __int_as_float(__ldg(prop + count + i));
    hit = t.u2 < __fdiv_rn(__fmul_rn(w, alpha), t.cap);
    if (hit) nxt[lane] = x;
  }
  still[i] = hit ? 0 : 1;
}

inline dim3 grid_of(int64_t items, int threads) {
  return dim3((unsigned)((items + threads - 1) / threads));
}

constexpr int kThreads = 256;

}  // namespace

// Each entry point launches one stage of K18 on `stream` and returns
// cudaGetLastError().  Buffers are row-major int32: stats (4, batch), prop
// (2, count); lanes are sorted int64 lane ids; mask and still are uint8.
// The slice is validated once when it is built (ops/walk.py
// ShardedWalkTables): indptr[i] + deg[i] <= len(cols), columns below n,
// each row's columns ascending.
extern "C" int walk2_stats_launch(const int32_t* indptr, const int32_t* cols,
                                  const float* vals, const int32_t* deg,
                                  const float* wmax, const float* wsum,
                                  const int32_t* cur, const int32_t* prev,
                                  int32_t* out, int64_t batch, int32_t n,
                                  int64_t row_lo, int64_t rps, float inv_p,
                                  void* stream) {
  if (batch > 0)
    stats_kernel<<<grid_of(batch, kThreads), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        indptr, cols, vals, deg, wmax, wsum, cur, prev, out, batch, n,
        row_lo, rps, inv_p);
  return (int)cudaGetLastError();
}

extern "C" int walk2_pending_launch(const int32_t* stats, uint8_t* mask,
                                    int64_t batch, float inv_q,
                                    void* stream) {
  if (batch > 0)
    pending_kernel<<<grid_of(batch, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(stats, mask, batch,
                                                          inv_q);
  return (int)cudaGetLastError();
}

extern "C" int walk2_propose_launch(const int32_t* indptr, const int32_t* cols,
                                    const float* vals, const int32_t* stats,
                                    int64_t batch, const int64_t* lanes,
                                    int64_t count, const int32_t* cur,
                                    const int32_t* prev, int hop, int rnd,
                                    int64_t base, uint32_t k0, uint32_t k1,
                                    int32_t n, int64_t row_lo, int64_t rps,
                                    float inv_q, int32_t* out, void* stream) {
  if (count > 0)
    propose_kernel<<<grid_of(count, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        indptr, cols, vals, stats, batch, lanes, count, cur, prev, hop, rnd,
        base, k0, k1, n, row_lo, rps, inv_q, out);
  return (int)cudaGetLastError();
}

extern "C" int walk2_member_launch(const int32_t* indptr, const int32_t* cols,
                                   const int32_t* deg, const int32_t* stats,
                                   int64_t batch, const int64_t* lanes,
                                   int64_t count, const int32_t* prop,
                                   const int32_t* prev, int hop, int rnd,
                                   int tries, int64_t base, uint32_t k0,
                                   uint32_t k1, int32_t n, int64_t row_lo,
                                   int64_t rps, float inv_q, int32_t* out,
                                   void* stream) {
  if (count > 0)
    member_kernel<<<grid_of(count, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        indptr, cols, deg, stats, batch, lanes, count, prop, prev, hop, rnd,
        tries, base, k0, k1, n, row_lo, rps, inv_q, out);
  return (int)cudaGetLastError();
}

extern "C" int walk2_decide_launch(const int32_t* stats, int64_t batch,
                                   const int64_t* lanes, int64_t count,
                                   const int32_t* prop, const int32_t* member,
                                   const int32_t* prev, int hop, int rnd,
                                   int tries, int64_t base, uint32_t k0,
                                   uint32_t k1, int32_t n, float inv_q,
                                   int32_t* nxt, uint8_t* still,
                                   void* stream) {
  if (count > 0)
    decide_kernel<<<grid_of(count, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        stats, batch, lanes, count, prop, member, prev, hop, rnd, tries, base,
        k0, k1, n, inv_q, nxt, still);
  return (int)cudaGetLastError();
}
