// K6: dense left-Markov transition P = D^-1 A scattered from CSR, with the
// degree vector and the volume, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's _dense_markov (cleora_tpu/algorithms.py:397-404):
//
//   A        = zeros(n, n).at[rows, cols].add(vals)     (duplicates sum)
//   deg[i]   = max(sum_j A[i, j], 1e-10)
//   P[i, :]  = A[i, :] / deg[i]
//   vol      = sum_ij A[i, j]
//
// The matrix arrives in CSR (row-sorted COO is CSR), P is float32 (n, n),
// deg float32 (n), vol one float64.
//
// Bound on the card: bytes.  A call reads the CSR (8 (n+1) + 8 nnz B) and
// must write P once (4 n^2 B: 1.283 ms at n = 32,768 at 3.35 TB/s); the
// arithmetic is one add per entry and one division per non-zero.  What the
// card really writes at is a fill's rate: chip_smoke.py times
// torch.empty((n, n)).zero_() beside K6 as its measured floor.
//
// Design: a warp writes one segment of a row (kSegment floats, the last
// segment to the row's end), building it a window of kWindow floats at a
// time in its own shared tile and storing each window once, whole 16-byte
// streaming stores (__stcs): P is written once, with no zero pass in
// device memory, no global atomics and no read-back (the first design, a
// block a row, zeroed the row, added the entries with global atomics and
// read the row back to divide it: P crossed the memory bus about twice,
// 2.84 ms at n = 32,768 on an H100).  The warp sums its row's values in
// the first design's order (thread t of 256 summing entries t + 256 k in
// turn, an xor butterfly over each 32, a butterfly over the 8 warp sums),
// so deg and each row's vol term stay bitwise; segment 0 writes deg and
// adds the row's sum into vol (one float64 atomicAdd a row).  A row of at
// most 32 entries (the graphs' rows: about 7) holds them in registers, a
// lane an entry, loaded once for the segment; a window that none of them
// falls in is stored as zeros straight from registers, and a window that
// holds some is built in the shared tile: the entries added with shared
// atomics (duplicates sum), each non-zero divided by deg with IEEE
// division (__fdiv_rn, as before: a row without duplicate entries is
// bitwise the first design's), stored, and its groups zeroed again.  A
// longer row (a hub) re-reads its entries for each window from the L1 /
// L2.  The segments are the grid's units (a row's in order), so the
// write front moves through P as one stream and a warp's per-row latency
// (its indptr, then its entries) hides behind the other warps' stores;
// no block barrier.  n % 4 != 0: a row's windows start at the 16-byte
// boundary at or before its column 0, and the groups it shares with its
// neighbours (its first and last) are stored a float at a time, its own
// floats only.
//
// Segment and window width, block shape and store instruction by
// measurement (scripts/torch_k4_k6_probe.py at n = 32,768, NVIDIA H100
// 80GB HBM3, 700.00 W, against a fill of P at 1.304-1.311 ms): segments
// of 2,048 floats 1.330 ms, 4,096 1.341-1.347, 8,192 1.349-1.364, 16,384
// 1.367-1.400; windows of 256 / 512 / 1,024 floats within 1 %; blocks of
// 128 threads within 0.5 %; plain stores (a one-line edit of store4)
// 1.37-1.41.  A first form, flat 16 KB tiles each built by a whole block
// with a barrier and one working warp between tiles, ran 2.33-2.45 ms
// whatever its tile or block size.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps, each on its own segment
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 4;  // float4 groups a lane a window
constexpr int kWindow = 32 * 4 * kGroups;  // floats a warp builds at once
constexpr int64_t kSegment = 2048;  // floats of a row a warp writes

// The sum of vals[start, end) in the first design's order: 256 threads,
// thread t summing entries start + t + 256 k in k order, each warp's 32
// partial sums by an xor butterfly, then a butterfly over the 8 warps'
// sums with 0 in the lanes past the eighth.  One warp takes the 256
// threads' place: virtual warp w's sums in turn, lane l holding thread
// 32 w + l's.  Every lane returns the sum.
__device__ __forceinline__ float row_sum(const float* __restrict__ vals,
                                         int64_t start, int64_t end,
                                         int lane) {
  const int64_t deg = end - start;
  const int warps = deg >= 256 ? 8 : (int)((deg + 31) >> 5);
  float part = 0.f;  // lane w < 8: virtual warp w's sum
  for (int w = 0; w < warps; ++w) {
    float s = 0.f;
    for (int64_t e = start + 32 * w + lane; e < end; e += 256)
      s += __ldg(vals + e);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kAll, s, off);
    if (lane == w) part = s;
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(kAll, part, off);
  return part;
}

// A 16-byte store that bypasses the caches' retention (st.global.cs).
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// A warp a unit: segment `unit % segs` of row `unit / segs`.
__global__ void __launch_bounds__(kThreads)
    dense_markov_kernel(const int64_t* __restrict__ indptr,
                        const int32_t* __restrict__ indices,
                        const float* __restrict__ vals, float* __restrict__ p,
                        float* __restrict__ deg, double* vol, int64_t n,
                        int64_t segs, int64_t units) {
  __shared__ __align__(16) float tiles[kWarps][kWindow];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t unit = (int64_t)blockIdx.x * kWarps + warp;
  if (unit >= units) return;  // the whole warp: no barrier in this kernel
  float4* t4 = reinterpret_cast<float4*>(tiles[warp]);
  float* tile = tiles[warp];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kGroups; ++j) t4[lane + 32 * j] = zero;
  const int64_t row = unit / segs;
  const int64_t seg = unit - row * segs;
  const int64_t start = __ldg(indptr + row);
  const int64_t end = __ldg(indptr + row + 1);
  const bool few = end - start <= 32;
  int col = 0;
  float val = 0.f;
  const bool held = few && lane < end - start;  // this lane's entry
  if (held) {
    col = __ldg(indices + start + lane);
    val = __ldg(vals + start + lane);
  }
  const float sum = row_sum(vals, start, end, lane);
  const float dn = fmaxf(sum, 1e-10f);
  if (seg == 0 && lane == 0) {
    deg[row] = dn;
    atomicAdd(vol, (double)sum);
  }
  const int64_t f = row * n;  // the flat index of the row's column 0
  const int64_t a0 = f & ~(int64_t)3;  // the 16-byte boundary at or before
  const int64_t span = f + n - a0;
  const int64_t s0 = seg * kSegment;
  const int64_t s1 = seg == segs - 1 ? span : s0 + kSegment;
  __syncwarp();  // the zeroed tile
  for (int64_t w0 = s0; w0 < s1; w0 += kWindow) {
    const int64_t wn = s1 - w0 < kWindow ? s1 - w0 : kWindow;
    const int64_t base = f - a0 - w0;  // the window offset of column 0
    bool mine = false;
    if (few) {
      const int64_t at = base + col;
      mine = held && at >= 0 && at < wn;
      if (mine) atomicAdd(tile + at, val);
    } else {
      for (int64_t e = start + lane; e < end; e += 32) {
        const int64_t at = base + __ldg(indices + e);
        if (at >= 0 && at < wn) {
          atomicAdd(tile + at, __ldg(vals + e));
          mine = true;
        }
      }
    }
    __syncwarp();  // the window's adds before its reads
    const bool any = __any_sync(kAll, mine);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int g = lane + 32 * j;
      const int64_t off = 4 * (int64_t)g;
      if (off >= wn) break;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if (any) {
        const float4 v = t4[g];
        t4[g] = zero;
        c[0] = v.x;
        c[1] = v.y;
        c[2] = v.z;
        c[3] = v.w;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c[q] != 0.f) c[q] = __fdiv_rn(c[q], dn);
      }
      const int64_t at = a0 + w0 + off;
      float* dst = p + at;
      if (at >= f && at + 4 <= f + n) {
        store4(dst, make_float4(c[0], c[1], c[2], c[3]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (at + q >= f && at + q < f + n) dst[q] = c[q];
      }
    }
    __syncwarp();  // the tile is zero again before the next window's adds
  }
}

}  // namespace

// Launches K6 on `stream` and returns cudaGetLastError().  `vol` must
// hold 0.0 on entry; p must be 16-byte aligned (checked by the Python
// wrapper).  A warp a segment of a row: n * ceil(n / kSegment) units.
extern "C" int dense_markov_launch(const int64_t* indptr,
                                   const int32_t* indices, const float* vals,
                                   float* p, float* deg, double* vol,
                                   int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t segs = (n + kSegment - 1) / kSegment;
  const int64_t units = n * segs;
  const int64_t blocks = (units + kWarps - 1) / kWarps;
  dense_markov_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, vals, p, deg, vol, n, segs, units);
  return (int)cudaGetLastError();
}
