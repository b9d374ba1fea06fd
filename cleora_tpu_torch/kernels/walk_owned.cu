// K17: a round of the first-order walks over row-sharded walk tables, each
// owned lane advanced through its local hops, hand-written for Hopper
// (sm_90a).
//
// Replaces the JAX package's sharded-table walk engine
// cleora_tpu/algorithms.py _device_walk_sharded_jit (:1380), whose scan body
// computes each hop on the device that owns the lane's current row and
// psums the disjoint contributions, one collective a hop.  Rank r holds rows
// [row_lo, row_lo + rps) of the self-loop-free walk CSR with indptr local to
// its own cols slice (ops/walk.py walk_table_slice).  A lane's state is
// (node, hop): walks[b, hop] = node is the last entry resolved.  In a round,
// the slice that the lane belongs to (the owner of its node's row; the root
// rank for a lane at the sentinel or past its last hop) takes it:
//
//   owned row:  hop after hop in registers, K8's hop (walk_hop.cuh) while
//               the next row is the slice's too, up to the last hop; each
//               resolved node written to walks[b, hop]; a row of degree 0
//               (a dead end) fills the rest of the walk with n
//   sentinel:   the rest of the walk filled with n (pad lanes, whose start
//               is n, and lanes past n)
//
// and writes its new state; the first round also writes walks[b, 0].
// Every entry of the walk matrix has exactly one writer over the slices, so
// with the walk matrix zeroed on every rank one sum over the ranks (or the
// slices writing one matrix in one process) gives K8's walks bit for bit;
// the states, written the same way (0 where another slice takes the lane),
// sum to every lane's state.  A round also counts the lanes that the round
// before left short of their last hop, from the summed state, the same on
// every rank.  At one slice every row is owned, so one launch walks the
// whole batch.
//
// Bound on the card: bytes, in 32-byte sectors, as K8's.  An owned hop
// makes three dependent random reads (deg, indptr, cols), each of which
// moves a sector, and writes one int32; every round reads each lane's state
// and writes the state of the lanes the slice takes.
//
// Design: one thread a lane (K8's layout: a lane's walk row in registers,
// its entries written in order), so a round costs the launches and one
// collective of the (2, B) state, not one of each a hop.  The live count is
// one atomic a warp.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "walk_hop.cuh"

namespace {

namespace cg = cooperative_groups;

__global__ void walk_owned_kernel(const int32_t* __restrict__ indptr,
                                  const int32_t* __restrict__ cols,
                                  const int32_t* __restrict__ deg,
                                  const int32_t* __restrict__ nodes,
                                  const int32_t* __restrict__ hops,
                                  int32_t* __restrict__ walks, int64_t batch,
                                  int walk_length, int64_t base, uint32_t k0,
                                  uint32_t k1, int32_t n, int64_t row_lo,
                                  int64_t rps, int root,
                                  int32_t* __restrict__ state, int exclusive,
                                  int32_t* __restrict__ live) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int last = walk_length - 1;
  int32_t cur = __ldg(nodes + b);
  int h = hops ? __ldg(hops + b) : 0;
  if (live) {  // the lanes the last round left short of their last hop
    const cg::coalesced_group team = cg::coalesced_threads();
    const unsigned short_of = team.ballot(h < last);
    if (team.thread_rank() == 0 && short_of)
      atomicAdd(live, __popc(short_of));
  }
  const bool valid = cur >= 0 && cur < n;
  int64_t lr = (int64_t)cur - row_lo;
  const bool mine =
      (h >= last || !valid) ? root != 0 : (lr >= 0 && lr < rps);
  if (!mine) {
    if (exclusive) {
      state[b] = 0;
      state[batch + b] = 0;
    }
    return;
  }
  int32_t* row = walks + b * walk_length;
  if (h == 0) row[0] = cur;
  if (h < last) {
    bool dead = !valid;
    if (valid) {
      const uint64_t g = (uint64_t)(base + b);
      const uint32_t g0 = (uint32_t)g, g1 = (uint32_t)(g >> 32);
      while (true) {
        const int32_t d = __ldg(deg + lr);
        if (d == 0) {
          dead = true;
          break;
        }
        cur = walk_hop::next(indptr, cols, lr, d, g0, g1, (uint32_t)h, k0,
                             k1);
        row[++h] = cur;
        lr = (int64_t)cur - row_lo;
        if (h == last || lr < 0 || lr >= rps) break;
      }
    }
    if (dead) {
      while (h < last) row[++h] = n;
      cur = n;
    }
  }
  if (state) {
    state[b] = cur;
    state[batch + b] = h;
  }
}

}  // namespace

// Launches one round of K17 on `stream` and returns cudaGetLastError().
// `nodes` and `hops` (null: every hop 0, the first round) are (batch,)
// int32; `walks` is (batch, walk_length) int32, row-major; `state` (null:
// a slice holding every row, which finishes every lane) is (2 batch,)
// int32, the lanes' new nodes and hops: written for the lanes the slice
// takes, and 0 for the others when `exclusive` (the one slice in its
// process; else the caller zeroes it, or the slices of one process write
// every lane between them).  `live` (may be null) gets the count of the
// input lanes short of their last hop added.  The slice (rps rows, local
// offsets) is validated once when it is built (ops/walk.py
// ShardedWalkTables).
extern "C" int walk_owned_launch(const int32_t* indptr, const int32_t* cols,
                                 const int32_t* deg, const int32_t* nodes,
                                 const int32_t* hops, int32_t* walks,
                                 int64_t batch, int walk_length, int64_t base,
                                 uint32_t k0, uint32_t k1, int32_t n,
                                 int64_t row_lo, int64_t rps, int root,
                                 int32_t* state, int exclusive,
                                 int32_t* live, void* stream) {
  if (batch > 0 && walk_length > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 128;
    const dim3 grid((unsigned)((batch + threads - 1) / threads));
    walk_owned_kernel<<<grid, threads, 0, s>>>(
        indptr, cols, deg, nodes, hops, walks, batch, walk_length, base, k0,
        k1, n, row_lo, rps, root, state, exclusive && state, live);
  }
  return (int)cudaGetLastError();
}
