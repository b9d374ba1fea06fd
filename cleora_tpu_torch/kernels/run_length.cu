// K10: run-length reduction of sorted keys, in two forms, hand-written for
// Hopper (sm_90a).
//
// Replaces the reduce half of the JAX package's counting programs,
// cleora_tpu/ops/cooccur.py _reduce_walks_sweep_impl (:236-254) and
// _sort_reduce (:46-71), and the whole of its chain merge, _merge_impl
// (:339-346), which concatenates two ranges and sorts them again.
//
// Sweep form (run_length_launch):
//   keys: ascending int64, key = ((cen % passes) * n + cen) * n + ctx, with
//         the dead key INT64_MAX (masked lanes) sorted to the end;
//   out:  cen[r], ctx[r], cnt[r] (its length) for the r-th run and
//         bounds[s] = the index
//         of the first run of partition s = key / n^2 (bounds[passes] = the
//         number of runs), so partition s holds runs bounds[s]..bounds[s+1].
// Merge form (run_length_merge_launch):
//   a, b: two ranges (cen, ctx, cnt), each sorted by (cen, ctx) with unique
//         pairs;
//   out:  their union sorted by (cen, ctx), a pair present in both once with
//         the two counts added, and m_out[0] = its length.
// Counts are summed modulo 2^32 into int32, as the JAX program's int32
// segment_sum wraps; ops/cooccur.py:_check_count_overflow catches the first
// wrap.  The caller sizes the outputs for the worst case (one run a key, or
// |a| + |b|) and narrows them to the length the kernel reports.
//
// Bound on the card: bytes.  The sweep reads each key once and writes 12
// bytes a run; the merge reads 12 bytes an entry of a and b and
// writes 12 bytes an output entry.
//
// Design: one pass, no sort.  A block owns a tile of 2,048 consecutive keys
// (8 a thread, vector loads), marks the run heads (the tile's first key
// compared with the key before it), scans the marks with warp shuffles, and
// takes the tile's first output slot by a decoupled look-back over the
// earlier tiles' run counts (each tile publishes its count, then its
// inclusive prefix, in one 64-bit status word; tiles take their ids in
// launch order from a counter, so every tile waits only on tiles that
// already run).  A run is closed by the tile that holds its head; a run
// that leaves the tile is finished by one warp walking the keys after the
// tile, 32 at a time.  The triples are staged in shared
// memory and written once, coalesced; a run's count is the difference of
// the key positions at its head and at the next head (or at the first dead
// key).  A head's (cen, ctx) comes from two
// divisions by n through a double reciprocal, corrected exactly.  The
// partitions' run counts need no atomics: the thread at the key where the
// partition changes writes that partition's first run index.
//
// The merge form finds each tile's split of a and b by a binary search on
// its diagonal of the merge path (one thread a tile boundary), loads the
// tile's share of both ranges into shared memory, merges eight entries a
// thread (a before b on equal pairs), and reduces them like the sweep: a
// pair present in both ranges is two adjacent entries, summed by the thread
// that holds the first one (reading the next thread's, or the next tile's,
// entry from device memory).  Pairs compare as (cen << 32) | ctx, which
// orders them as cen * n + ctx does for 0 <= ctx < n.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int64_t kDead = INT64_MAX;
constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
// blocks an SM holds at once, which caps the registers a thread may use:
// a block's loads come in one burst, so more blocks keep more bytes in
// flight (5 and 6 were the fastest of 4-8 on the H100)
constexpr int kSweepMinBlocks = 5;
constexpr int kMergeMinBlocks = 6;

// tile status word: flag in the top two bits, the value below them
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = kFlagAggregate - 1;

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long v) {
  atomicExch(word, v);
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

// Exclusive prefix of v over the block's threads in thread order, and the
// block's total.  Uses `warp_tot` (kWarps entries); the caller syncs before
// reusing it.
template <typename T>
__device__ __forceinline__ T block_scan(T v, T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(kAll, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  T base = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T t = warp_tot[w];
    if (w < warp) base += t;
    sum += t;
  }
  total = sum;
  return base + inc - v;
}

// Warp 0 of tile `tile`: publish the tile's aggregate, look back over the
// earlier tiles' words until an inclusive prefix, publish this tile's, and
// return the tile's exclusive prefix (on every lane).
__device__ unsigned long long look_back(unsigned long long* status, int tile,
                                        unsigned long long agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) publish(status, kFlagPrefix | agg);
    return 0;
  }
  if (lane == 0) publish(status + tile, kFlagAggregate | agg);
  unsigned long long excl = 0;
  int pred = tile - 1;
  while (true) {
    const int idx = pred - lane;
    unsigned long long w;
    do {
      w = idx >= 0 ? peek(status + idx) : kFlagPrefix;
    } while (!__all_sync(kAll, (w >> 62) != 0));
    const unsigned prefix = __ballot_sync(kAll, (w >> 62) == 2);
    const int first = prefix ? __ffs(prefix) - 1 : 32;
    unsigned long long v = lane <= first ? (w & kValueMask) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
    excl += v;
    if (prefix) break;
    pred -= 32;
  }
  if (lane == 0) publish(status + tile, kFlagPrefix | (excl + agg));
  return excl;
}

// ------------------------------------------------------------------ sweep
// q = v / n and r = v % n for 0 <= v < 2^63 and 0 < n < 2^31: a double
// estimate of the quotient (off by at most one: v/n < 2^52 here) corrected
// exactly, in place of a 64-bit division routine.
__device__ __forceinline__ int64_t divmod(int64_t v, int64_t n, double inv_n,
                                          int64_t& r) {
  int64_t q = (int64_t)((double)v * inv_n);
  r = v - q * n;
  while (r < 0) {
    --q;
    r += n;
  }
  while (r >= n) {
    ++q;
    r -= n;
  }
  return q;
}

__global__ void __launch_bounds__(kThreads, kSweepMinBlocks)
    run_sweep_kernel(const int64_t* __restrict__ keys, int64_t len,
                     int64_t n, double inv_n, int passes, int vec,
                     int* tile_counter, unsigned long long* status,
                     int32_t* __restrict__ cen, int32_t* __restrict__ ctx,
                     int32_t* __restrict__ cnt, int64_t* __restrict__ bounds) {
  __shared__ int32_t s_cen[kTile];
  __shared__ int32_t s_ctx[kTile];
  // the key position in the tile at each run's head, and at the end of the
  // tile's last run: a run's count is the difference of two neighbours
  __shared__ uint32_t s_val[kTile + 1];
  __shared__ uint32_t s_wtot[kWarps];
  __shared__ int s_tile;
  __shared__ unsigned long long s_base;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const int64_t t0 = (int64_t)tile * kTile;
  const int64_t i0 = t0 + (int64_t)tid * kItems;

  int64_t k[kItems];
  if (vec && i0 + kItems <= len) {
    const longlong2* p = reinterpret_cast<const longlong2*>(keys + i0);
#pragma unroll
    for (int j = 0; j < kItems / 2; ++j) {
      const longlong2 v = __ldg(p + j);
      k[2 * j] = v.x;
      k[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      k[j] = i0 + j < len ? __ldg(keys + i0 + j) : kDead;
  }
  // the key before this thread's first (the previous lane's last; dead past
  // len), and the key after the tile
  int64_t before = __shfl_up_sync(kAll, k[kItems - 1], 1);
  if (lane == 0) before = (i0 > 0 && i0 <= len) ? __ldg(keys + i0 - 1) : kDead;

  unsigned heads = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t prev = j ? k[j - 1] : before;
    const bool head = k[j] != kDead && (i0 + j == 0 || k[j] != prev);
    heads |= (unsigned)head << j;
  }
  uint32_t tile_runs;
  const uint32_t q0 = block_scan<uint32_t>(__popc(heads), s_wtot, tile_runs);
  const uint32_t e0 = (uint32_t)(tid * kItems);  // the position in the tile
  if (warp == 0) {
    const unsigned long long base = look_back(status, tile, tile_runs);
    if (lane == 0) s_base = base;
  }

  // heads: the run's pair and its position, staged at its slot; the
  // first dead key (or len) after a live one ends the tile's last run
  {
    uint32_t q = q0, e = e0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (heads >> j & 1) {
        int64_t r;
        const int64_t cn = divmod(k[j], n, inv_n, r);  // part * n + cen
        int64_t cr;
        divmod(cn, n, inv_n, cr);
        s_cen[q] = (int32_t)cr;
        s_ctx[q] = (int32_t)r;
        s_val[q] = e;
        ++q;
      }
      const int64_t prev = j ? k[j - 1] : before;
      if (k[j] == kDead && prev != kDead && q > 0) s_val[q] = e;
      ++e;
    }
  }
  // a tile whose last key is live: its last run ends after the walk over
  // the keys that follow the tile and repeat that key
  if (warp == kWarps - 1 && tile_runs > 0) {
    const int64_t last = __shfl_sync(kAll, k[kItems - 1], 31);
    if (last != kDead) {
      uint32_t sum = 0;
      for (int64_t p = t0 + kTile;; p += 32) {
        const int64_t idx = p + lane;
        const bool same = idx < len && __ldg(keys + idx) == last;
        const unsigned stop = __ballot_sync(kAll, !same);
        const int first = stop ? __ffs(stop) - 1 : 32;
        sum += (uint32_t)first;
        if (stop) break;
      }
      if (lane == 0) s_val[tile_runs] = kTile + sum;
    }
  }
  __syncthreads();
  const int64_t base = (int64_t)s_base;
  for (uint32_t q = tid; q < tile_runs; q += kThreads) {
    cen[base + q] = s_cen[q];
    ctx[base + q] = s_ctx[q];
    cnt[base + q] = (int32_t)(s_val[q + 1] - s_val[q]);
  }
  // partition bounds: bounds[s] = the first run of a partition >= s, written
  // by the thread at the key where the partition (dead keys: `passes`)
  // changes, and bounds[passes] at the end of the stream
  if (i0 < len) {
    const int64_t nn = n * n;
    int part = -1;
    if (i0 > 0) part = before == kDead ? passes : (int)(before / nn);
    uint32_t q = q0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j < len && part < passes &&
          (k[j] == kDead || k[j] >= (int64_t)(part + 1) * nn)) {
        const int now = k[j] == kDead ? passes : (int)(k[j] / nn);
        for (int s = part + 1; s <= now; ++s) bounds[s] = base + q;
        part = now;
      }
      q += heads >> j & 1;
    }
    if (i0 + kItems >= len)  // this thread holds the last key
      for (int s = part + 1; s <= passes; ++s) bounds[s] = base + q;
  }
}

// ------------------------------------------------------------------ merge
__device__ __forceinline__ uint64_t pair_key(const int32_t* cen,
                                             const int32_t* ctx, int64_t i) {
  return ((uint64_t)(uint32_t)__ldg(cen + i) << 32) |
         (uint64_t)(uint32_t)__ldg(ctx + i);
}

// Number of a's entries among the first `diag` entries of the merge (a
// before b on equal pairs).
__device__ int64_t merge_split(const int32_t* cen_a, const int32_t* ctx_a,
                               int64_t ma, const int32_t* cen_b,
                               const int32_t* ctx_b, int64_t mb,
                               int64_t diag) {
  int64_t lo = diag > mb ? diag - mb : 0;
  int64_t hi = diag < ma ? diag : ma;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (pair_key(cen_a, ctx_a, mid) <= pair_key(cen_b, ctx_b, diag - 1 - mid))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void merge_splits_kernel(const int32_t* __restrict__ cen_a,
                                    const int32_t* __restrict__ ctx_a,
                                    int64_t ma,
                                    const int32_t* __restrict__ cen_b,
                                    const int32_t* __restrict__ ctx_b,
                                    int64_t mb, int n_tiles,
                                    int64_t* __restrict__ splits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > n_tiles) return;
  const int64_t total = ma + mb;
  const int64_t diag = (int64_t)t * kTile < total ? (int64_t)t * kTile : total;
  splits[t] = merge_split(cen_a, ctx_a, ma, cen_b, ctx_b, mb, diag);
}

__global__ void __launch_bounds__(kThreads, kMergeMinBlocks)
    merge_kernel(const int32_t* __restrict__ cen_a,
                 const int32_t* __restrict__ ctx_a,
                 const int32_t* __restrict__ cnt_a, int64_t ma,
                 const int32_t* __restrict__ cen_b,
                 const int32_t* __restrict__ ctx_b,
                 const int32_t* __restrict__ cnt_b, int64_t mb,
                 const int64_t* __restrict__ splits, int n_tiles,
                 int* tile_counter, unsigned long long* status,
                 int32_t* __restrict__ cen, int32_t* __restrict__ ctx,
                 int32_t* __restrict__ cnt, int64_t* __restrict__ m_out) {
  // the tile's share of a then of b; reused to stage the output
  __shared__ uint64_t s_key[kTile];
  __shared__ uint32_t s_cnt[kTile];
  __shared__ uint32_t s_wtot[kWarps];
  __shared__ int s_tile;
  __shared__ unsigned long long s_base;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const int64_t total = ma + mb;
  const int64_t d0 = (int64_t)tile * kTile;
  const int64_t a0 = splits[tile];
  const int64_t a1 = splits[tile + 1];
  const int64_t b0 = d0 - a0;
  const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;
  // (clamped so that ranges that are not sorted give some merge, never a
  // read or write out of bounds)
  const int na = (int)max((int64_t)0, min(a1 - a0, ma - a0));
  const int nb = (int)max((int64_t)0, min(d1 - d0 - na, mb - b0));
  // the tile's na + nb <= kTile entries, kItems a thread, all loads issued
  // before the first store (the loop is unrolled)
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = tid + j * kThreads;
    if (i < na) {
      s_key[i] = pair_key(cen_a, ctx_a, a0 + i);
      s_cnt[i] = (uint32_t)__ldg(cnt_a + a0 + i);
    } else if (i < na + nb) {
      s_key[i] = pair_key(cen_b, ctx_b, b0 + i - na);
      s_cnt[i] = (uint32_t)__ldg(cnt_b + b0 + i - na);
    }
  }
  __syncthreads();

  // this thread's split of the tile's diagonal tid * kItems
  const int dt = min(tid * kItems, na + nb);
  int lo = dt > nb ? dt - nb : 0;
  int hi = dt < na ? dt : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_key[mid] <= s_key[na + dt - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  int ai = lo, bi = dt - lo;
  // the merged entry before this thread's first: the larger of the last
  // entries taken from a and from b (global indices a0 + ai, b0 + bi)
  const bool has_before = a0 + ai > 0 || b0 + bi > 0;
  uint64_t before = 0;
  if (a0 + ai > 0)
    before = ai ? s_key[ai - 1] : pair_key(cen_a, ctx_a, a0 - 1);
  if (b0 + bi > 0) {
    const uint64_t kb =
        bi ? s_key[na + bi - 1] : pair_key(cen_b, ctx_b, b0 - 1);
    before = kb > before ? kb : before;
  }
  uint64_t k[kItems];
  uint32_t c[kItems];
  int live = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool take_a = ai < na && (bi >= nb || s_key[ai] <= s_key[na + bi]);
    const bool take_b = !take_a && bi < nb;
    if (take_a) {
      k[j] = s_key[ai];
      c[j] = s_cnt[ai];
      ++ai;
      ++live;
    } else if (take_b) {
      k[j] = s_key[na + bi];
      c[j] = s_cnt[na + bi];
      ++bi;
      ++live;
    } else {
      k[j] = 0;
      c[j] = 0;
    }
  }
  // the merged entry after this thread's last, and its count (from shared
  // memory inside the tile, from device memory past it)
  const int64_t ga = a0 + ai, gb = b0 + bi;
  bool has_after = false;
  uint64_t after = 0;
  uint32_t after_cnt = 0;
  {
    const bool in_a = ga < ma, in_b = gb < mb;
    const uint64_t ka = ai < na ? s_key[ai] : in_a ? pair_key(cen_a, ctx_a, ga)
                                                   : 0;
    const uint64_t kb = bi < nb ? s_key[na + bi]
                                : in_b ? pair_key(cen_b, ctx_b, gb) : 0;
    if (in_a && (!in_b || ka <= kb)) {
      has_after = true;
      after = ka;
      after_cnt = ai < na ? s_cnt[ai] : (uint32_t)__ldg(cnt_a + ga);
    } else if (in_b) {
      has_after = true;
      after = kb;
      after_cnt = bi < nb ? s_cnt[na + bi] : (uint32_t)__ldg(cnt_b + gb);
    }
  }
  unsigned heads = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool head = j < live && (j ? k[j] != k[j - 1]
                                     : (!has_before || k[0] != before));
    heads |= (unsigned)head << j;
  }
  uint32_t tile_runs;
  const uint32_t q0 = block_scan<uint32_t>(__popc(heads), s_wtot, tile_runs);
  if (warp == 0) {
    const unsigned long long base = look_back(status, tile, tile_runs);
    if (lane == 0) {
      s_base = base;
      if (tile == n_tiles - 1) *m_out = (int64_t)(base + tile_runs);
    }
  }
  __syncthreads();  // every thread is done reading the tile's inputs
  {
    uint32_t q = q0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (heads >> j & 1) {
        // an equal pair follows at most once: the same pair of the other
        // range, in this thread or just after it
        uint32_t sum = c[j];
        if (j + 1 < live) {
          if (k[j + 1] == k[j]) sum += c[j + 1];
        } else if (has_after && after == k[j]) {
          sum += after_cnt;
        }
        s_key[q] = k[j];
        s_cnt[q] = sum;
        ++q;
      }
    }
  }
  __syncthreads();
  const int64_t base = (int64_t)s_base;
  for (uint32_t q = tid; q < tile_runs; q += kThreads) {
    const uint64_t key = s_key[q];
    cen[base + q] = (int32_t)(key >> 32);
    ctx[base + q] = (int32_t)(key & 0xffffffffu);
    cnt[base + q] = (int32_t)s_cnt[q];
  }
}

int tiles_for(int64_t len) { return (int)((len + kTile - 1) / kTile); }

}  // namespace

// Launches the sweep form on `stream` and returns cudaGetLastError().
// `scratch` holds ceil(len / 2048) + passes + 2 int64, which the launch
// zeroes: the look-back's status words (one a tile), the tile counter,
// then `bounds` (passes + 1 words: the first run of each partition, and
// bounds[passes] = the number of runs).  `out` holds 3 * len int32: cen,
// ctx and cnt, of which the first bounds[passes] each are written.  `vec`:
// keys aligned to 16 bytes.
extern "C" int run_length_launch(const int64_t* keys, int64_t len, int64_t n,
                                 int passes, int vec, int64_t* scratch,
                                 int32_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_for(len);
  cudaMemsetAsync(scratch, 0, sizeof(int64_t) * (tiles + passes + 2), s);
  if (len > 0) {
    auto* status = reinterpret_cast<unsigned long long*>(scratch);
    auto* counter = reinterpret_cast<int*>(scratch + tiles);
    int64_t* bounds = scratch + tiles + 1;
    run_sweep_kernel<<<tiles, kThreads, 0, s>>>(
        keys, len, n, 1.0 / (double)n, passes, vec, counter, status, out,
        out + len, out + 2 * len, bounds);
  }
  return (int)cudaGetLastError();
}

// Launches the merge form on `stream` and returns cudaGetLastError().
// `scratch` holds 2 * ceil((ma + mb) / 2048) + 3 int64: the status words
// and the tile counter (zeroed by the launch, as for the sweep), the
// merge's length (zeroed, then written), and each tile's split.  `out`
// holds 3 * (ma + mb) int32: cen, ctx and cnt, of which the first (the
// merge's length) each are written.
extern "C" int run_length_merge_launch(
    const int32_t* cen_a, const int32_t* ctx_a, const int32_t* cnt_a,
    int64_t ma, const int32_t* cen_b, const int32_t* ctx_b,
    const int32_t* cnt_b, int64_t mb, int64_t* scratch, int32_t* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = ma + mb;
  const int tiles = tiles_for(total);
  cudaMemsetAsync(scratch, 0, sizeof(int64_t) * (tiles + 2), s);
  if (total > 0) {
    auto* status = reinterpret_cast<unsigned long long*>(scratch);
    auto* counter = reinterpret_cast<int*>(scratch + tiles);
    int64_t* m_out = scratch + tiles + 1;
    int64_t* splits = scratch + tiles + 2;
    merge_splits_kernel<<<(tiles + 1 + 255) / 256, 256, 0, s>>>(
        cen_a, ctx_a, ma, cen_b, ctx_b, mb, tiles, splits);
    merge_kernel<<<tiles, kThreads, 0, s>>>(
        cen_a, ctx_a, cnt_a, ma, cen_b, ctx_b, cnt_b, mb, splits, tiles,
        counter, status, out, out + total, out + 2 * total, m_out);
  }
  return (int)cudaGetLastError();
}
