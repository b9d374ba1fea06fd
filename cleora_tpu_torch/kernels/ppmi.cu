// K11: the positive-PMI transform of counted pairs, hand-written for Hopper
// (sm_90a).
//
// Replaces the JAX package's PPMI programs, cleora_tpu/ops/cooccur.py
// _colsum_impl (:926-936) and _ppmi_range_impl (:939-965).  A range holds
// one hash partition's unique pairs, sorted by (cen, ctx), with int32 counts;
// every center lives in exactly one range, contexts in all of them.
//
// ppmi_colsum (once per range): col[ctx] += cnt and total += cnt, as exact
//   64-bit integer sums: four consecutive entries a thread, one atomic add
//   an entry into col and one a block of 1,024 entries into total.
// ppmi (once per range, after every range's colsum), two passes:
//   ppmi_rows: the range's CSR row pointer indptr (n + 1 int64: the
//     range's entries in (cen, ctx) order are the CSR of its rows in
//     original row order, with ctx as the column indices and vals as the
//     values), each row's sum rs of cnt as an exact 64-bit integer, and a
//     flag where cen decreases or leaves [0, n);
//   ppmi_vals: for each entry
//     vals = max(logf(max(w * total / (max(rs, 1e-10) * max(cs, 1e-10)),
//                         1e-15)), 0)
//     in float32 and in the JAX program's order, where w = cnt and cs =
//     col[ctx]; the sums are converted to float32 once (round to nearest),
//     so they equal the JAX program's float32 scatter-adds wherever those
//     are exact (below 2^24), and they do not change from run to run.  It
//     raises the flag for a ctx outside [0, n).
//
// Bound on the card: bytes.  colsum reads ctx and cnt (8 B per entry) and
// col once (8 n B), with one 8-byte atomic per entry: the L2's atomic rate
// holds it above that bound, as it holds index_add_.  ppmi must read cen,
// ctx and cnt once and write vals and indptr once (16 B per entry +
// 8 (n + 1) B); the two passes read cen and cnt twice (24 B per entry),
// and the column sums' gathers (one 32-byte sector of L2 per entry) hold
// ppmi_vals above its share of that.
//
// Design.  XLA scatters float32 row and column sums over every slot of
// padded buckets.  Here no thread walks a row: a thread that did would
// serialise its row's entries (about 810 on phase 7's ranges, in strided
// loads) and the longest row would set the tail.  ppmi_rows gives each warp 1,024 consecutive
// entries, 128 at a time, four consecutive ones to a lane: a lane adds the
// runs (entries of one cen) that begin and end inside its four entries,
// and the warp joins the runs that cross lanes by a segmented inclusive
// scan of the lanes' tail runs by shuffles (the sort keeps a run
// contiguous); a run is added into rs[cen] by one 64-bit atomic where it
// ends, or carried into the warp's next 128 entries, so a row costs one
// atomic per warp it spans.  At a run's first entry the lane writes indptr
// from the previous center + 1 up to its own (the gap of empty rows), and
// at the range's last entry the tail up to n.  Integer sums are exact in
// any order.  ppmi_vals is entry-parallel, one entry a thread: it gathers
// rs[cen] (cen is sorted, so a warp reads one or two rows' sums) and
// col[ctx] (from L2), and applies the arithmetic unchanged (logf is the
// accurate library function, not __logf; the products and the quotient
// are round-to-nearest), so each entry's value does not depend on the
// layout.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kWarpEntries = 1024;  // entries a warp of ppmi_rows scans
constexpr int kSumEntries = 4;      // entries a thread of ppmi_colsum

// col[ctx[i]] += cnt[i] for the kSumEntries entries of a thread
// (streaming loads), and one atomic add of the block's sum into total.
__global__ void __launch_bounds__(kThreads)
    ppmi_colsum_kernel(const int32_t* __restrict__ ctx,
                       const int32_t* __restrict__ cnt, int64_t m,
                       unsigned long long* __restrict__ col,
                       unsigned long long* __restrict__ total) {
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int64_t i0 =
      ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kSumEntries;
  unsigned long long v = 0ull;
  for (int64_t i = i0; i < i0 + kSumEntries && i < m; ++i) {
    const unsigned long long w = (long long)__ldcs(cnt + i);
    atomicAdd(col + __ldcs(ctx + i), w);
    v += w;
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kAll, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0ull;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    if (s) atomicAdd(total, s);
  }
}

// indptr[k] = e for k in [from, to] (clipped to [0, n]).
__device__ __forceinline__ void fill(int64_t* __restrict__ indptr,
                                     int64_t from, int64_t to, int64_t n,
                                     int64_t e) {
  for (int64_t k = from < 0 ? 0 : from; k <= to && k <= n; ++k) indptr[k] = e;
}

__device__ __forceinline__ bool valid_id(int32_t c, int64_t n) {
  return c >= 0 && (int64_t)c < n;
}

// Each warp takes kWarpEntries consecutive entries, kChunk at a time: a
// lane loads kLane consecutive entries, adds
// the runs that begin and end inside them itself, and the warp joins the
// runs that cross lanes by a segmented inclusive scan of each lane's tail
// run (segments: lanes whose tail key is equal, which the sort keeps
// contiguous).  A run is added into rs[cen] where it ends (by the lane
// whose next entry is another center: its head run's lane, or its tail
// run's), and a run that goes on into the next chunk is carried there.
constexpr int kLane = 4;
constexpr int kChunk = 32 * kLane;
constexpr int32_t kPast = 0x7fffffff;  // the key of entries past the span

__global__ void __launch_bounds__(kThreads)
    ppmi_rows_kernel(const int32_t* __restrict__ cen,
                     const int32_t* __restrict__ cnt, int64_t m, int64_t n,
                     int64_t* __restrict__ indptr,
                     unsigned long long* __restrict__ rs,
                     unsigned long long* __restrict__ flag) {
  const int lane = threadIdx.x & 31;
  const int64_t lo =
      (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) * kWarpEntries;
  if (lo >= m) return;  // the whole warp
  const int64_t hi = lo + kWarpEntries < m ? lo + kWarpEntries : m;
  bool bad = false;
  // the center of the entry before the chunk, and the sum of its run so
  // far where that run goes on into the chunk
  int64_t before = lo == 0 ? -1 : (int64_t)__ldg(cen + lo - 1);
  unsigned long long carry = 0ull;
  for (int64_t b0 = lo; b0 < hi; b0 += kChunk) {
    const int64_t e0 = b0 + kLane * lane;
    int32_t c[kLane], w[kLane];
#pragma unroll
    for (int j = 0; j < kLane; ++j) {
      const bool in = e0 + j < hi;
      c[j] = in ? __ldg(cen + e0 + j) : kPast;
      w[j] = in ? __ldg(cnt + e0 + j) : 0;
    }
    // the key after the chunk (the next chunk's first entry)
    const int32_t after =
        lane == 31 && b0 + kChunk < hi ? __ldg(cen + b0 + kChunk) : kPast;
    const int32_t kh = c[0], kt = c[kLane - 1];
    int64_t prev = __shfl_up_sync(kAll, kt, 1);
    if (lane == 0) prev = before;
    int32_t next = __shfl_down_sync(kAll, kh, 1);
    if (lane == 31) next = after;
    // row starts, order and range checks, and the runs inside the lane
    unsigned long long run = 0ull, head = 0ull;
    bool whole = true;  // no key changes inside the lane
#pragma unroll
    for (int j = 0; j < kLane; ++j) {
      const int64_t e = e0 + j;
      const int64_t p = j == 0 ? prev : (int64_t)c[j - 1];
      if (e < hi) {
        if (!valid_id(c[j], n) || c[j] < p) {
          bad = true;
        } else if (c[j] != p) {
          fill(indptr, p + 1, c[j], n, e);  // a row starts at e
        }
        if (e == m - 1 && valid_id(c[j], n)) fill(indptr, c[j] + 1, n, n, m);
      }
      if (j > 0 && c[j] != c[j - 1]) {
        if (whole) {
          head = run;  // the head run ends inside the lane
        } else if (valid_id(c[j - 1], n)) {
          atomicAdd(rs + c[j - 1], run);  // a run inside the lane
        }
        whole = false;
        run = 0ull;
      }
      run += (unsigned long long)(long long)w[j];
    }
    // the scan of the tail runs; a whole lane 0 continuing the carried run
    unsigned long long s = run;
    if (lane == 0 && whole && (int64_t)kt == before) s += carry;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long su = __shfl_up_sync(kAll, s, off);
      const int32_t ku = __shfl_up_sync(kAll, kt, off);
      if (lane >= off && ku == kt) s += su;
    }
    unsigned long long up = __shfl_up_sync(kAll, s, 1);
    if (lane == 0) up = carry;
    // a head run ends inside the lane: with the run it continues, if any
    if (!whole && valid_id(kh, n))
      atomicAdd(rs + kh, head + ((int64_t)kh == prev ? up : 0ull));
    // the tail run ends here unless the next entry continues it
    const bool open = next == kt;
    if (!open && valid_id(kt, n)) atomicAdd(rs + kt, s);
    carry = __shfl_sync(kAll, open ? s : 0ull, 31);
    before = __shfl_sync(kAll, kt, 31);
  }
  if (__any_sync(kAll, bad) && lane == 0) *flag = 1ull;
}

__device__ __forceinline__ float ppmi_value(int32_t c, int32_t x, int32_t w,
                                            int64_t n, float tot,
                                            const long long* __restrict__ rs,
                                            const long long* __restrict__ col,
                                            bool& bad) {
  const bool ok = valid_id(c, n) && valid_id(x, n);
  bad |= !ok;
  const float rsf = fmaxf(__ll2float_rn(ok ? __ldg(rs + c) : 0ll), 1e-10f);
  const float cs = fmaxf(__ll2float_rn(ok ? __ldg(col + x) : 0ll), 1e-10f);
  const float q = __fdiv_rn(__fmul_rn((float)w, tot), __fmul_rn(rsf, cs));
  return fmaxf(logf(fmaxf(q, 1e-15f)), 0.f);
}

// One entry a thread: every thread's gathers are in flight at once (four
// entries a thread, or a grid-stride loop loading its next entries ahead,
// were no faster: the column sums' gathers from L2 set the pace).
__global__ void __launch_bounds__(kThreads)
    ppmi_vals_kernel(const int32_t* __restrict__ cen,
                     const int32_t* __restrict__ ctx,
                     const int32_t* __restrict__ cnt, int64_t m, int64_t n,
                     const long long* __restrict__ col,
                     const long long* __restrict__ total,
                     const long long* __restrict__ rs,
                     float* __restrict__ vals,
                     unsigned long long* __restrict__ flag) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  bool bad = false;
  vals[i] = ppmi_value(__ldg(cen + i), __ldg(ctx + i), __ldg(cnt + i), n,
                       __ll2float_rn(__ldg(total)), rs, col, bad);
  if (bad) *flag = 1ull;
}

dim3 grid_for(int64_t threads) {
  return dim3((unsigned)((threads + kThreads - 1) / kThreads));
}

}  // namespace

// Launches ppmi_colsum on `stream` and returns cudaGetLastError().  `col`
// (n int64) and `total` (1 int64) accumulate across calls.
extern "C" int ppmi_colsum_launch(const int32_t* ctx, const int32_t* cnt,
                                  int64_t m, long long* col, long long* total,
                                  void* stream) {
  if (m > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    ppmi_colsum_kernel<<<grid_for((m + kSumEntries - 1) / kSumEntries),
                         kThreads,
                         0, s>>>(
        ctx, cnt, m, reinterpret_cast<unsigned long long*>(col),
        reinterpret_cast<unsigned long long*>(total));
  }
  return (int)cudaGetLastError();
}

// Launches ppmi_rows then ppmi_vals on `stream` and returns the first
// cudaGetLastError() that is not 0.  `scratch` is n + 1 int64 set to 0 by
// the caller: the row sums, then the flag, which ends nonzero where cen
// decreases or a cen or ctx leaves [0, n) (vals and indptr are then
// meaningless, but every write stayed in bounds).  The caller writes indptr
// for an empty range.
extern "C" int ppmi_launch(const int32_t* cen, const int32_t* ctx,
                           const int32_t* cnt, int64_t m, int64_t n,
                           const long long* col, const long long* total,
                           float* vals, int64_t* indptr, long long* scratch,
                           void* stream) {
  if (m > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    unsigned long long* rs = reinterpret_cast<unsigned long long*>(scratch);
    const int64_t warps = (m + kWarpEntries - 1) / kWarpEntries;
    ppmi_rows_kernel<<<grid_for(32 * warps), kThreads, 0, s>>>(
        cen, cnt, m, n, indptr, rs, rs + n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ppmi_vals_kernel<<<grid_for(m), kThreads, 0, s>>>(
        cen, ctx, cnt, m, n, col, total, scratch, vals, rs + n);
  }
  return (int)cudaGetLastError();
}
