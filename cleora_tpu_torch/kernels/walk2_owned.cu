// K18: the second-order (Node2Vec p/q) walk over row-sharded weighted walk
// tables, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's sharded-table second-order engine
// cleora_tpu/algorithms.py _device_walk2_sharded_jit (:1574).  Rank r holds
// rows [row_lo, row_lo + rps) of the weighted walk CSR (indptr local to its
// cols/vals slice, deg, wmax, wsum; ops/walk.py walk_table_slice).  Every
// rank holds the lanes' current and previous nodes, and the row split is
// contiguous, so every rank knows which slice owns each row.  A hop has
// two kinds of lane:
//
//   local  the first hop, or cur and prev on one slice: that slice runs
//          K12's whole hop in one thread (walk2_hop.cuh, the code K12
//          runs), and so does it for a row of degree 0 or a dead row;
//   cross  cur and prev on different slices.
//
// Stage local (owner of cur, every lane) writes, for the lanes whose cur
// the slice owns, next + 1 for a lane it resolves and 0 for a cross lane,
// with the cross lane's d, wmax and w_bt beside it; 0 everywhere else.  One
// all-reduce (SUM, int32; a float travels by its bits) has exactly one
// nonzero term a lane.  A slice that holds every row writes the next node
// itself (the sentinel n for a pad lane): one launch a hop, no collective.
//
// The cross lanes then run their rejection rounds in chunks of R rounds
// (R a power of two, at most 32): the proposals of a round depend only on
// its uniforms, cur, prev and the summed stats, never on an earlier round.
//
//   propose (owner of cur):  the R proposals x and weights w of each lane
//   member  (owner of prev): R membership bits in one int32 a lane, 1 when
//           the round tests x (not backtrack, x != prev, not the last round)
//           and x is in prev's row
//   decide  (every rank):    the first round that hits, in order, writes
//           the next node; the lanes that miss all R rounds stay pending
//
// with one all-reduce after propose and one after member.  The uniforms of
// round r of hop h of walk g = base + lane are K12's (Philox4x32-10 at
// counter (g lo, g hi, h, r + 1)), and every float operation is K12's
// round-to-nearest intrinsic in K12's order, so every rank takes the same
// decisions and the walks are bitwise K12's at every batch size and slice
// count.
//
// Bound on the card: bytes, in 32-byte sectors: the random reads of deg,
// indptr, wmax and wsum and the binary searches in cur's and prev's rows,
// as K12's.  The local stage is latency-bound as K12 is (one thread a
// lane, dependent random reads); the round stages are one thread per lane
// and round, so a chunk's R searches are in flight at once.

#include <cstdint>

#include <cuda_runtime.h>

#include "walk2_hop.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;

// The local row of global node `v`, or -1 when this slice does not own it.
__device__ __forceinline__ int64_t local_row(int32_t v, int32_t n,
                                             int64_t row_lo, int64_t rps) {
  if (v < 0 || v >= n) return -1;
  const int64_t lr = (int64_t)v - row_lo;
  return (lr >= 0 && lr < rps) ? lr : -1;
}

// `shared`: out is (4, batch) (res, d, wmax, w_bt); else out is the next
// nodes (batch,) and the slice holds every row.
__global__ void local_kernel(const int32_t* __restrict__ indptr,
                             const int32_t* __restrict__ cols,
                             const float* __restrict__ vals,
                             const int32_t* __restrict__ deg,
                             const float* __restrict__ wmax,
                             const float* __restrict__ wsum,
                             const int32_t* __restrict__ cur,
                             const int32_t* __restrict__ prev,
                             int32_t* __restrict__ out, int shared,
                             int64_t batch, int hop, int64_t base,
                             uint32_t k0, uint32_t k1, int32_t n,
                             int64_t row_lo, int64_t rps, float inv_p,
                             float inv_q, int tries) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int32_t p = __ldg(prev + b);
  const int64_t lr = local_row(__ldg(cur + b), n, row_lo, rps);
  int32_t res = shared ? 0 : n, d = 0;
  float wm = 0.0f, w_bt = 0.0f;
  if (lr >= 0) {
    const bool first = !(p >= 0 && p < n);
    const int64_t plr = first ? -1 : local_row(p, n, row_lo, rps);
    const walk2::Head t = walk2::hop_head(indptr, cols, vals, deg, wmax, wsum,
                                          lr, p, first, inv_p, inv_q);
    if (first || plr >= 0 || t.d <= 0 || t.dead) {
      res = walk2::hop(indptr, cols, vals, deg, t, p, plr, first,
                       (uint64_t)(base + b), hop, k0, k1, n, inv_q, tries) +
            shared;
    } else {
      d = t.d;
      wm = t.wm;
      w_bt = t.w_bt;
    }
  }
  out[b] = res;
  if (shared) {
    out[batch + b] = d;
    out[2 * batch + b] = __float_as_int(wm);
    out[3 * batch + b] = __float_as_int(w_bt);
  }
}

// The replicated terms of round `rnd` of cross lane `lane`, from the summed
// stats (3 rows of `stride` int32: d, wmax, w_bt).
struct Round {
  walk2::Uniforms u;
  walk2::Terms s;
  int32_t d, prev;
  bool first, is_bt;
};

__device__ __forceinline__ Round round_terms(const int32_t* __restrict__ stats,
                                             int64_t stride, int32_t lane,
                                             const int32_t* __restrict__ prev,
                                             int hop, int rnd, int64_t base,
                                             uint32_t k0, uint32_t k1,
                                             int32_t n, float inv_q) {
  Round t;
  t.d = __ldg(stats + lane);
  t.s = walk2::hop_terms(t.d, __int_as_float(__ldg(stats + stride + lane)),
                         __int_as_float(__ldg(stats + 2 * stride + lane)),
                         inv_q);
  t.prev = __ldg(prev + lane);
  t.first = !(t.prev >= 0 && t.prev < n);
  t.u = walk2::round_uniforms((uint64_t)(base + lane), hop, rnd, k0, k1);
  t.is_bt = !t.first && t.u.u0 < t.s.pi;
  return t;
}

// One thread per (lane i, round r0 + j), t = i * R + j; out is (2, count R).
__global__ void propose_kernel(const int32_t* __restrict__ indptr,
                               const int32_t* __restrict__ cols,
                               const float* __restrict__ vals,
                               const int32_t* __restrict__ stats,
                               int64_t batch,
                               const int32_t* __restrict__ lanes,
                               int64_t count, const int32_t* __restrict__ cur,
                               const int32_t* __restrict__ prev, int hop,
                               int r0, int log_r, int tries, int64_t base,
                               uint32_t k0, uint32_t k1, int32_t n,
                               int64_t row_lo, int64_t rps, float inv_q,
                               int32_t* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = count << log_r;
  if (t >= total) return;
  const int rnd = r0 + (int)(t & ((1 << log_r) - 1));
  const int32_t lane = __ldg(lanes + (t >> log_r));
  int32_t x = 0, w = 0;
  const int64_t lr = local_row(__ldg(cur + lane), n, row_lo, rps);
  if (lr >= 0 && rnd < tries) {
    const Round r = round_terms(stats, batch, lane, prev, hop, rnd, base, k0,
                                k1, n, inv_q);
    if (!r.is_bt) {
      const int32_t e = walk2::proposal(__ldg(indptr + lr), r.d, r.u.u1);
      x = __ldg(cols + e);
      w = __float_as_int(__ldg(vals + e));
    }
  }
  out[t] = x;
  out[total + t] = w;
}

// One thread per (lane i, round r0 + j); a warp's ballot packs each lane's
// R bits, bit j for round r0 + j, into out[i].
__global__ void member_kernel(const int32_t* __restrict__ indptr,
                              const int32_t* __restrict__ cols,
                              const int32_t* __restrict__ deg,
                              const int32_t* __restrict__ stats,
                              int64_t batch,
                              const int32_t* __restrict__ lanes,
                              int64_t count, const int32_t* __restrict__ prop,
                              const int32_t* __restrict__ prev, int hop,
                              int r0, int log_r, int tries, int64_t base,
                              uint32_t k0, uint32_t k1, int32_t n,
                              int64_t row_lo, int64_t rps, float inv_q,
                              int32_t* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = count << log_r;
  const int j = (int)(t & ((1 << log_r) - 1));
  bool hit = false;
  if (t < total) {
    const int rnd = r0 + j;
    const int32_t lane = __ldg(lanes + (t >> log_r));
    const int32_t p = __ldg(prev + lane);
    const int64_t plr = local_row(p, n, row_lo, rps);
    const int32_t x = __ldg(prop + t);
    if (plr >= 0 && x != p && rnd < tries - 1) {
      const Round r = round_terms(stats, batch, lane, prev, hop, rnd, base,
                                  k0, k1, n, inv_q);
      if (!r.is_bt) {
        const int32_t lo = __ldg(indptr + plr);
        hit = walk2::in_row(cols, lo, lo + __ldg(deg + plr), x);
      }
    }
  }
  // every thread of the warp reaches the ballot (blocks are whole warps)
  const unsigned bits = __ballot_sync(kAll, hit);
  if (t < total && j == 0) {
    const int shift = (int)(threadIdx.x & 31);
    const unsigned keep = log_r == 5 ? kAll : ((1u << (1 << log_r)) - 1u);
    out[t >> log_r] = (int32_t)((bits >> shift) & keep);
  }
}

// One thread per lane: the first of the chunk's rounds that hits.
__global__ void decide_kernel(const int32_t* __restrict__ stats,
                              int64_t batch,
                              const int32_t* __restrict__ lanes,
                              int64_t count, const int32_t* __restrict__ prop,
                              const int32_t* __restrict__ member,
                              const int32_t* __restrict__ prev, int hop,
                              int r0, int log_r, int tries, int64_t base,
                              uint32_t k0, uint32_t k1, int32_t n,
                              float inv_q, int32_t* __restrict__ nxt,
                              uint8_t* __restrict__ still) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int32_t lane = __ldg(lanes + i);
  const int64_t total = count << log_r;
  const unsigned bits = (unsigned)__ldg(member + i);
  uint8_t pending = 1;
  for (int j = 0; j < (1 << log_r) && r0 + j < tries; ++j) {
    const int rnd = r0 + j;
    const Round r = round_terms(stats, batch, lane, prev, hop, rnd, base, k0,
                                k1, n, inv_q);
    if (r.is_bt) {
      nxt[lane] = r.prev;
      pending = 0;
      break;
    }
    const int64_t at = (i << log_r) + j;
    const int32_t x = __ldg(prop + at);
    bool take = r.first || rnd == tries - 1;
    if (!take) {
      const float alpha =
          x == r.prev ? 0.0f : (((bits >> j) & 1u) ? 1.0f : inv_q);
      take = walk2::accepts(r.u.u2, __int_as_float(__ldg(prop + total + at)),
                            alpha, r.s.cap);
    }
    if (take) {
      nxt[lane] = x;
      pending = 0;
      break;
    }
  }
  still[i] = pending;
}

constexpr int kThreads = 256;

inline dim3 grid_of(int64_t items) {
  return dim3((unsigned)((items + kThreads - 1) / kThreads));
}

}  // namespace

// Each entry point launches one stage of K18 on `stream` and returns
// cudaGetLastError().  Buffers are row-major int32: the local stage's out
// (4, batch) or (batch,), stats its rows 1-3 (3, batch), prop (2, count R),
// member (count,); lanes are int32 lane ids in ascending order; still is
// uint8; R = 2^log_r.  The slice is validated once when it is built
// (ops/walk.py ShardedWalkTables): indptr[i] + deg[i] <= len(cols),
// columns below n, each row's columns ascending.
extern "C" int walk2_local_launch(const int32_t* indptr, const int32_t* cols,
                                  const float* vals, const int32_t* deg,
                                  const float* wmax, const float* wsum,
                                  const int32_t* cur, const int32_t* prev,
                                  int32_t* out, int shared, int64_t batch,
                                  int hop, int64_t base, uint32_t k0,
                                  uint32_t k1, int32_t n, int64_t row_lo,
                                  int64_t rps, float inv_p, float inv_q,
                                  int tries, void* stream) {
  if (batch > 0)
    local_kernel<<<grid_of(batch), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        indptr, cols, vals, deg, wmax, wsum, cur, prev, out, shared, batch,
        hop, base, k0, k1, n, row_lo, rps, inv_p, inv_q, tries);
  return (int)cudaGetLastError();
}

extern "C" int walk2_propose_launch(const int32_t* indptr, const int32_t* cols,
                                    const float* vals, const int32_t* stats,
                                    int64_t batch, const int32_t* lanes,
                                    int64_t count, const int32_t* cur,
                                    const int32_t* prev, int hop, int r0,
                                    int log_r, int tries, int64_t base,
                                    uint32_t k0, uint32_t k1, int32_t n,
                                    int64_t row_lo, int64_t rps, float inv_q,
                                    int32_t* out, void* stream) {
  if (count > 0)
    propose_kernel<<<grid_of(count << log_r), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        indptr, cols, vals, stats, batch, lanes, count, cur, prev, hop, r0,
        log_r, tries, base, k0, k1, n, row_lo, rps, inv_q, out);
  return (int)cudaGetLastError();
}

extern "C" int walk2_member_launch(const int32_t* indptr, const int32_t* cols,
                                   const int32_t* deg, const int32_t* stats,
                                   int64_t batch, const int32_t* lanes,
                                   int64_t count, const int32_t* prop,
                                   const int32_t* prev, int hop, int r0,
                                   int log_r, int tries, int64_t base,
                                   uint32_t k0, uint32_t k1, int32_t n,
                                   int64_t row_lo, int64_t rps, float inv_q,
                                   int32_t* out, void* stream) {
  if (count > 0)
    member_kernel<<<grid_of(count << log_r), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        indptr, cols, deg, stats, batch, lanes, count, prop, prev, hop, r0,
        log_r, tries, base, k0, k1, n, row_lo, rps, inv_q, out);
  return (int)cudaGetLastError();
}

extern "C" int walk2_decide_launch(const int32_t* stats, int64_t batch,
                                   const int32_t* lanes, int64_t count,
                                   const int32_t* prop, const int32_t* member,
                                   const int32_t* prev, int hop, int r0,
                                   int log_r, int tries, int64_t base,
                                   uint32_t k0, uint32_t k1, int32_t n,
                                   float inv_q, int32_t* nxt, uint8_t* still,
                                   void* stream) {
  if (count > 0)
    decide_kernel<<<grid_of(count), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        stats, batch, lanes, count, prop, member, prev, hop, r0, log_r, tries,
        base, k0, k1, n, inv_q, nxt, still);
  return (int)cudaGetLastError();
}
