// K16: halo send-slab pack, hand-written for Hopper (sm_90a).
//
// Replaces the gather that packs the boundary rows of the sharded loop's
// halo exchange, `jnp.take(x_local, send_idx, axis=0)` in
// cleora_tpu/parallel/embed.py:_propagate_local (:138), and its twin in the
// hierarchical exchange (:104, :106):
//
//   out[s, :] = x[idx[s], :]        for every slot s of the (P, M) plan
//
// x is the shard's (rows_per_shard, D) state, float32 or bfloat16; out is
// the (P, M, D) send slab in the same dtype, which the caller hands to
// all_to_all_single.  The copy is bitwise, so the kernel moves bytes and
// never looks at the values.
//
// Bound on the card: bytes.  A call reads idx (4 P M B) and one row of x per
// slot (P M D sizeof(x) B) and writes as many bytes to out; it does no
// arithmetic at all.
//
// Design: one warp per slot.  Lane 0's index load is broadcast to the warp,
// and the 32 lanes stream the row in 16-byte vectors (4 float32 or 8
// bfloat16 values), so neighbouring lanes read and write neighbouring
// addresses and each row is one or a few fully used 512-byte transactions.
// Rows whose byte width or pointers do not allow 16-byte vectors take
// 4-byte words, and bfloat16 rows of odd width 2-byte halves.  The TPU's
// scalar-prefetched indices become the warp's own index load.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename V>
__global__ void halo_pack_kernel(const int32_t* __restrict__ idx,
                                 const V* __restrict__ x, V* __restrict__ out,
                                 int64_t n_slots, int64_t row_vecs) {
  const int64_t slot =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (slot >= n_slots) return;
  const int lane = threadIdx.x & 31;
  const int64_t src = __ldg(idx + slot);
  const V* s = x + src * row_vecs;
  V* d = out + slot * row_vecs;
  for (int64_t v = lane; v < row_vecs; v += 32) d[v] = __ldg(s + v);
}

template <typename V>
void launch(const int32_t* idx, const void* x, void* out, int64_t n_slots,
            int64_t row_bytes, cudaStream_t stream) {
  const int64_t row_vecs = row_bytes / (int64_t)sizeof(V);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((n_slots + kWarpsPerBlock - 1) / kWarpsPerBlock));
  halo_pack_kernel<V><<<grid, block, 0, stream>>>(
      idx, static_cast<const V*>(x), static_cast<V*>(out), n_slots, row_vecs);
}

}  // namespace

// Launches K16 on `stream` and returns cudaGetLastError().  `vec_bytes` is
// 16, 4 or 2: row_bytes and both pointers must be multiples of it (checked
// by the Python wrapper).  Every idx must lie in [0, rows of x) (checked on
// the host when the plan is built).
extern "C" int halo_pack_launch(const int32_t* idx, const void* x, void* out,
                                int64_t n_slots, int64_t row_bytes,
                                int vec_bytes, void* stream) {
  if (n_slots > 0 && row_bytes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec_bytes == 16) {
      launch<uint4>(idx, x, out, n_slots, row_bytes, s);
    } else if (vec_bytes == 4) {
      launch<unsigned int>(idx, x, out, n_slots, row_bytes, s);
    } else {
      launch<unsigned short>(idx, x, out, n_slots, row_bytes, s);
    }
  }
  return (int)cudaGetLastError();
}
