// K5: CSR SpMM fused with the recurrences that consume it, hand-written for
// Hopper (sm_90a).
//
// Replaces the loop bodies of the JAX package's spectral programs in
// cleora_tpu/algorithms.py: _weighted_sum_jit (:125-128, RandNE's
// acc += w_i * N^i R), _cheb_jit (:201-212, ProNE's Chebyshev step),
// katz in _hope_rsvd_jit (:285-294, the Neumann series of HOPE) and the
// walk `y = spmm; acc += y` of _netmf_block_jit (:595-597):
//
//   s         = sum_{e in row i} vals[e] * x[indices[e], :]
//   out[i, :] = a * s + b * self[i, :] + c * z[i, :]
//   acc[i, :] += d * out[i, :]                       (when acc is given)
//
// self is x itself on one device.  In the sharded siblings
// (parallel/algorithms.py, the port of cleora_tpu/parallel/algorithms.py)
// x is the gather table (the all-gathered rows or the received halo slab,
// which may have more or fewer rows than the shard) and self the shard's
// own N rows, as K1's residual operand is in the sharded loop.  z and acc
// may be null.  The b term is skipped when b == 0 and the c term when z is
// null, so neither row is read then.  Everything is float32.
//
// Bound on the card: bytes.  A call reads the CSR (8 (N+1) + 8 nnz B) and x,
// optionally self, z and acc (4 N D B each), and writes out and acc
// (4 N D B each), for 2 nnz D + 6 N D flops: a fraction of a flop per byte.
//
// Design: XLA fuses the elementwise tail of each step into the program
// around its SpMM; unfused, each step would re-read and re-write three to
// five state-sized tensors.  Here the thread that holds a row's sum in
// registers (K1's row walk: one row of threads per output row, one float4
// column group per thread and column tile, four gathers in flight) applies
// the whole step before it stores, so every state tensor moves once.  The
// tail is written with explicit round-to-nearest multiplies and adds in the
// plain version's order (no fused multiply-add), so the two differ only by
// the order of the row sum.  out must not alias x (other rows gather it).
//
// Wide panels (NetMF's blocked walk, _netmf_block_jit's `y = spmm; acc +=
// y` at (200,000, 4,096): x is 3.28 GB, 65 times the L2; ProNE's
// Chebyshev step at (200,000, 256)) take the banded kernel.  The short-row
// kernel there gathers a whole x row from device memory for each entry
// (at NetMF's panel 1.02 times that floor, 9.785 ms, against 3.916 ms for
// each input once), and no loop order inside a row changes that.
// spmm_axpy_band cuts x's columns into bands of kernels.BAND_COLUMNS = 32
// (one 128-byte line of a row) and runs the rows band-major, every row
// taking band j before any row takes band j + 1, so a band of x (25.6 MB
// at 200,000 rows) leaves device memory about once and the rows' later
// gathers of it hit the L2; the CSR is read again for each band, mostly
// from the L2.  A row's 8 lanes hold its band segment (a float4 each),
// gather its entries' segments in edge order and apply the whole tail
// before the store, with streaming cache operators on out, acc, self and
// z so that they leave the L2 before the band does.  Its arithmetic is
// row_group4's, the short-row kernel's own code, so the two agree bit for
// bit.  What it cannot avoid: each row's pieces of out, acc, self and z
// (and the band's first read of x) are 128 bytes at the row stride of x,
// a device-memory access pattern far slower than whole rows; narrower
// bands (32- and 64-byte pieces) ran slower than the short-row kernel.
// Where a band of x's rows outgrows the budget (embed()'s and the
// Chebyshev siblings' 1.96 M rows at D = 256: 250 MB) the short-row kernel
// runs, at 1.03 times its gather floor there (6.585 against 6.412 ms); so
// does every call whose x fits the budget whole.
//
// Long rows (the rsvd apply of the walk siblings: a PPMI piece holds about
// 810 entries in each of its rows, and 7 of 8 rows of a piece are empty)
// take other kernels, over a row plan of the piece's non-empty rows
// (ops/spmm.py CsrMatrix.row_plan), on that route only.  The short-row
// kernel there would put the tail of one row and the head of the next in
// one warp (68 float4 groups at width 272), let every thread load every
// edge, walk all ~810 edges of a row serially, and gather almost every x
// row from device memory (x is 1.09 GB, the L2 50 MB), so it sat at 80 %
// of the gather floor (one x row from device memory per entry).
// spmm_axpy_long gives a row one warp (a column tile of up to 96 float4
// groups, so no warp holds two rows), loads its next 32 edges (index and
// value) in one coalesced load and broadcasts them with __shfl_sync, keeps
// four edges' gathers in flight, and walks the columns of x in bands small
// enough for the L2: one launch a band, every row taking its entries of
// that band (a row's columns ascend, so a per-row cursor carries it from
// band to band), so a band of x is read from device memory about once and
// gathered from the L2 by every row that needs it.  A row longer than the
// plan's slice length (a hub) is cut into slices, a warp each in
// spmm_axpy_slices, that take its chunks of 32 entries in turn, so each
// band's entries of a hub are spread over several warps at once.  Sums are
// added in a fixed order: a warp's band sums in band order in a scratch, a
// cut row's slice sums in slice order by spmm_axpy_join; no float atomics.
// Only the plan's rows are touched, and only acc: acc += d * a * (A @ x)
// there (b == 0, no z, no out).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void axpy4(float4& acc, float v, const float4& a) {
  acc.x += v * a.x;
  acc.y += v * a.y;
  acc.z += v * a.z;
  acc.w += v * a.w;
}

// a*s + b*xr + c*zr in the plain version's order and rounding
__device__ __forceinline__ float tail(float s, float a, float b, float xr,
                                      bool has_z, float c, float zr) {
  float o = __fmul_rn(a, s);
  if (b != 0.f) o = __fadd_rn(o, __fmul_rn(b, xr));
  if (has_z) o = __fadd_rn(o, __fmul_rn(c, zr));
  return o;
}

// A row's float4 column group [col0, col0 + 4) (kStream: out, acc, self and
// z through the streaming cache operators, so that they leave the L2 first
// and a band of x stays there).  The short-row and the banded kernel both
// run this, so their sums are the same chain of multiply-adds in edge
// order and their tails the same roundings: they agree bit for bit.
template <bool kStream>
__device__ __forceinline__ void row_group4(
    int64_t start, int64_t end, int64_t row, int64_t col0,
    const int32_t* __restrict__ indices, const float* __restrict__ vals,
    const float* __restrict__ x, const float* __restrict__ self,
    const float* __restrict__ z, float* acc_out, float* out, int64_t d,
    float a, float b, float c, float dd) {
  const bool has_z = z != nullptr;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t e = start;
  for (; e + 4 <= end; e += 4) {
    const int64_t c0 = __ldg(indices + e), c1 = __ldg(indices + e + 1);
    const int64_t c2 = __ldg(indices + e + 2), c3 = __ldg(indices + e + 3);
    const float v0 = __ldg(vals + e), v1 = __ldg(vals + e + 1);
    const float v2 = __ldg(vals + e + 2), v3 = __ldg(vals + e + 3);
    const float4 a0 = load4(x + c0 * d + col0);
    const float4 a1 = load4(x + c1 * d + col0);
    const float4 a2 = load4(x + c2 * d + col0);
    const float4 a3 = load4(x + c3 * d + col0);
    axpy4(s, v0, a0);
    axpy4(s, v1, a1);
    axpy4(s, v2, a2);
    axpy4(s, v3, a3);
  }
  for (; e < end; ++e) {
    const int64_t col = __ldg(indices + e);
    axpy4(s, __ldg(vals + e), load4(x + col * d + col0));
  }
  const int64_t at = row * d + col0;
  float4 xr = make_float4(0.f, 0.f, 0.f, 0.f), zr = xr;
  if (kStream) {
    if (b != 0.f) xr = __ldcs(reinterpret_cast<const float4*>(self + at));
    if (has_z) zr = __ldcs(reinterpret_cast<const float4*>(z + at));
  } else {
    if (b != 0.f) xr = load4(self + at);
    if (has_z) zr = load4(z + at);
  }
  float4 o;
  o.x = tail(s.x, a, b, xr.x, has_z, c, zr.x);
  o.y = tail(s.y, a, b, xr.y, has_z, c, zr.y);
  o.z = tail(s.z, a, b, xr.z, has_z, c, zr.z);
  o.w = tail(s.w, a, b, xr.w, has_z, c, zr.w);
  float4* ow = reinterpret_cast<float4*>(out + at);
  float4* uw = reinterpret_cast<float4*>(acc_out + at);
  if (out != nullptr) {
    if (kStream)
      __stcs(ow, o);
    else
      *ow = o;
  }
  if (acc_out != nullptr) {
    float4 u = kStream ? __ldcs(uw) : *uw;
    u.x = __fadd_rn(u.x, __fmul_rn(dd, o.x));
    u.y = __fadd_rn(u.y, __fmul_rn(dd, o.y));
    u.z = __fadd_rn(u.z, __fmul_rn(dd, o.z));
    u.w = __fadd_rn(u.w, __fmul_rn(dd, o.w));
    if (kStream)
      __stcs(uw, u);
    else
      *uw = u;
  }
}

// row_group4 for one column (the scalar kernels: d % 4 != 0 or a tensor
// not aligned to 16 bytes).
template <bool kStream>
__device__ __forceinline__ void row_col(
    int64_t start, int64_t end, int64_t row, int64_t col0,
    const int32_t* __restrict__ indices, const float* __restrict__ vals,
    const float* __restrict__ x, const float* __restrict__ self,
    const float* __restrict__ z, float* acc_out, float* out, int64_t d,
    float a, float b, float c, float dd) {
  const bool has_z = z != nullptr;
  float s = 0.f;
  for (int64_t e = start; e < end; ++e) {
    const int64_t col = __ldg(indices + e);
    s += __ldg(vals + e) * __ldg(x + col * d + col0);
  }
  const int64_t at = row * d + col0;
  float xr = 0.f, zr = 0.f;
  if (b != 0.f) xr = kStream ? __ldcs(self + at) : __ldg(self + at);
  if (has_z) zr = kStream ? __ldcs(z + at) : __ldg(z + at);
  const float o = tail(s, a, b, xr, has_z, c, zr);
  if (out != nullptr) {
    if (kStream)
      __stcs(out + at, o);
    else
      out[at] = o;
  }
  if (acc_out != nullptr) {
    const float u = __fadd_rn(kStream ? __ldcs(acc_out + at) : acc_out[at],
                              __fmul_rn(dd, o));
    if (kStream)
      __stcs(acc_out + at, u);
    else
      acc_out[at] = u;
  }
}

// The short-row kernel: a row of threads (threadIdx.y) an output row, its
// lanes striding over the row's column groups.
template <bool kVec4>
__global__ void spmm_axpy_rows(const int64_t* __restrict__ indptr,
                               const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ indices,
                               const float* __restrict__ vals,
                               const float* __restrict__ x,
                               const float* __restrict__ self,
                               const float* __restrict__ z, float* acc_out,
                               float* out, int64_t n_rows, int64_t d, float a,
                               float b, float c, float dd) {
  const int64_t w = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (w >= n_rows) return;
  const int64_t row = rows ? (int64_t)rows[w] : w;
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  const int64_t groups = kVec4 ? d >> 2 : d;
  for (int64_t g = threadIdx.x; g < groups; g += blockDim.x) {
    if (kVec4)
      row_group4<false>(start, end, row, g << 2, indices, vals, x, self, z,
                        acc_out, out, d, a, b, c, dd);
    else
      row_col<false>(start, end, row, g, indices, vals, x, self, z, acc_out,
                     out, d, a, b, c, dd);
  }
}

// The banded kernel: x's columns cut into bands of `band` columns, every
// row taking band j before any row takes band j + 1, so that a band of x
// (x_rows * band * 4 bytes, sized by the wrapper to stay in the L2) leaves
// device memory about once and every later gather of it hits the L2.  A
// row's blockDim.x lanes hold its band segment, a column group each; a
// block holds blockDim.y rows.  blockIdx.y is the band, blockIdx.x the row
// chunk: blocks start in order of their linear index, band-major.
template <bool kVec4>
__global__ void spmm_axpy_band(const int64_t* __restrict__ indptr,
                               const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ indices,
                               const float* __restrict__ vals,
                               const float* __restrict__ x,
                               const float* __restrict__ self,
                               const float* __restrict__ z, float* acc_out,
                               float* out, int64_t n_rows, int64_t d, float a,
                               float b, float c, float dd, int64_t band) {
  const int64_t w = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int64_t col0 =
      (int64_t)blockIdx.y * band + (int64_t)threadIdx.x * (kVec4 ? 4 : 1);
  if (w >= n_rows || col0 >= d) return;
  const int64_t row = rows ? (int64_t)rows[w] : w;
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  if (kVec4)
    row_group4<true>(start, end, row, col0, indices, vals, x, self, z,
                     acc_out, out, d, a, b, c, dd);
  else
    row_col<true>(start, end, row, col0, indices, vals, x, self, z, acc_out,
                  out, d, a, b, c, dd);
}

constexpr int kLongWarps = 8;  // slices a block of spmm_axpy_long, a warp each
constexpr unsigned kAll = 0xffffffffu;

template <bool kVec4>
struct LongTile {
  static constexpr int kPer = kVec4 ? 4 : 1;    // floats a slot
  static constexpr int kSlots = kVec4 ? 3 : 8;  // slots a lane
  static constexpr int kCols = 32 * kSlots * kPer;  // columns a warp
};

template <bool kVec4>
__device__ __forceinline__ void gather_add(
    float (&s)[LongTile<kVec4>::kSlots][LongTile<kVec4>::kPer],
    const float* xr, float v, const bool (&ok)[LongTile<kVec4>::kSlots],
    int64_t c0, int lane) {
  using T = LongTile<kVec4>;
#pragma unroll
  for (int t = 0; t < T::kSlots; ++t) {
    if (!ok[t]) continue;
    const int64_t col = c0 + (int64_t)(lane + 32 * t) * T::kPer;
    if constexpr (kVec4) {
      const float4 g = load4(xr + col);
      s[t][0] += v * g.x;
      s[t][1] += v * g.y;
      s[t][2] += v * g.z;
      s[t][3] += v * g.w;
    } else {
      s[t][0] += v * __ldg(xr + col);
    }
  }
}

// The gathers of the first k of a warp's 32 loaded entries (column `col`
// and value `v` on lane j for entry j), shuffled to every lane, four in
// flight.
template <bool kVec4>
__device__ __forceinline__ void gather_entries(
    float (&s)[LongTile<kVec4>::kSlots][LongTile<kVec4>::kPer],
    const float* x, int64_t d, int col, float v, int k,
    const bool (&ok)[LongTile<kVec4>::kSlots], int64_t c0, int lane) {
  int j = 0;
  for (; j + 4 <= k; j += 4) {
    int cj[4];
    float vj[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      cj[u] = __shfl_sync(kAll, col, j + u);
      vj[u] = __shfl_sync(kAll, v, j + u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      gather_add<kVec4>(s, x + (int64_t)cj[u] * d, vj[u], ok, c0, lane);
  }
  for (; j < k; ++j) {
    const int cj = __shfl_sync(kAll, col, j);
    const float vj = __shfl_sync(kAll, v, j);
    gather_add<kVec4>(s, x + (int64_t)cj * d, vj, ok, c0, lane);
  }
}

// acc[row] += dd * (a * s) in the plain version's rounding
__device__ __forceinline__ float acc_tail(float u, float s, float a,
                                          float dd) {
  return __fadd_rn(u, __fmul_rn(dd, __fmul_rn(a, s)));
}

// One warp a (row, column tile), one launch a band of x's rows: the row's
// entries from its cursor up to the first column >= col_hi (all of them in
// the last band), 32 at a time, added to the scratch `part` (row w of it)
// between bands, and the tail after the last.  (The tail keeps K5's general
// form although the row plan's route passes b == 0, no z and no out: on the
// H100 a copy with the tail cut to acc alone ran slower at a PPMI piece's
// shape, with the same registers and no more spills.)
template <bool kVec4>
__global__ void __launch_bounds__(kLongWarps * 32)
    spmm_axpy_long(const int64_t* __restrict__ indptr,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ indices,
                   const float* __restrict__ vals,
                   const float* __restrict__ x,
                   const float* __restrict__ self,
                   const float* __restrict__ z, float* acc_out, float* out,
                   int64_t n_work, int64_t d, float a, float b, float c,
                   float dd, int64_t col_hi, int first, int last,
                   int64_t* __restrict__ cursor, float* __restrict__ part) {
  using T = LongTile<kVec4>;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kLongWarps + (threadIdx.x >> 5);
  if (w >= n_work) return;
  const int64_t row = rows ? (int64_t)rows[w] : w;
  const int64_t c0 = (int64_t)blockIdx.y * T::kCols;
  const int64_t slot = w * gridDim.y + blockIdx.y;
  bool ok[T::kSlots];
  float s[T::kSlots][T::kPer];
#pragma unroll
  for (int t = 0; t < T::kSlots; ++t) {
    ok[t] = c0 + (int64_t)(lane + 32 * t) * T::kPer < d;
#pragma unroll
    for (int q = 0; q < T::kPer; ++q) s[t][q] = 0.f;
  }
  const int64_t end = __ldg(indptr + row + 1);
  int64_t e = first ? __ldg(indptr + row) : cursor[slot];
  while (e < end) {
    const int64_t idx = e + lane;
    int col = 0;
    float v = 0.f;
    bool in = false;
    if (idx < end) {
      col = __ldg(indices + idx);
      v = __ldg(vals + idx);
      in = last || col < col_hi;
    }
    // the band's entries are a prefix of the 32: a row's columns ascend
    const int k = __popc(__ballot_sync(kAll, in));
    gather_entries<kVec4>(s, x, d, col, v, k, ok, c0, lane);
    e += k;
    if (k < 32) break;
  }
  if (!last && lane == 0) cursor[slot] = e;
  const bool has_z = z != nullptr;
#pragma unroll
  for (int t = 0; t < T::kSlots; ++t) {
    if (!ok[t]) continue;
    const int64_t col = c0 + (int64_t)(lane + 32 * t) * T::kPer;
    float* pw = part + w * d + col;
#pragma unroll
    for (int q = 0; q < T::kPer; ++q) {
      if (!first) s[t][q] += pw[q];
      if (!last) {
        pw[q] = s[t][q];
        continue;
      }
      const int64_t at = row * d + col + q;
      const float xr = b != 0.f ? __ldg(self + at) : 0.f;
      const float zr = has_z ? __ldg(z + at) : 0.f;
      const float o = tail(s[t][q], a, b, xr, has_z, c, zr);
      if (out != nullptr) out[at] = o;
      if (acc_out != nullptr)
        acc_out[at] = __fadd_rn(acc_out[at], __fmul_rn(dd, o));
    }
  }
}

// spmm_axpy_long's walk for the slices of the rows cut into several: slice
// w of row rows[w], cut into K = cuts[w] slices, takes the row's chunks of
// 32 entries j, j + K, j + 2K, ... from starts[w] (so every band's entries
// of a hub are spread over its K warps), and leaves its sum in `part` for
// spmm_axpy_join.
template <bool kVec4>
__global__ void __launch_bounds__(kLongWarps * 32)
    spmm_axpy_slices(const int64_t* __restrict__ indptr,
                     const int32_t* __restrict__ rows,
                     const int64_t* __restrict__ starts,
                     const int32_t* __restrict__ cuts, int64_t n_work,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ vals,
                     const float* __restrict__ x, int64_t d, int64_t col_hi,
                     int first, int last, int64_t* __restrict__ cursor,
                     float* __restrict__ part) {
  using T = LongTile<kVec4>;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kLongWarps + (threadIdx.x >> 5);
  if (w >= n_work) return;
  const int64_t row = __ldg(rows + w);
  const int64_t c0 = (int64_t)blockIdx.y * T::kCols;
  const int64_t slot = w * gridDim.y + blockIdx.y;
  bool ok[T::kSlots];
  float s[T::kSlots][T::kPer];
#pragma unroll
  for (int t = 0; t < T::kSlots; ++t) {
    ok[t] = c0 + (int64_t)(lane + 32 * t) * T::kPer < d;
#pragma unroll
    for (int q = 0; q < T::kPer; ++q) s[t][q] = 0.f;
  }
  const int64_t end = __ldg(indptr + row + 1);
  const int64_t e0 = __ldg(starts + w);  // the slice's first chunk
  const int64_t skip = 32 * (int64_t)(__ldg(cuts + w) - 1);  // the others'
  int64_t e = first ? e0 : cursor[slot];
  while (e < end) {
    const int64_t cs = e0 + (e - e0) / 32 * 32;  // the chunk that holds e
    const int64_t ce = cs + 32 < end ? cs + 32 : end;
    const int64_t idx = e + lane;
    int col = 0;
    float v = 0.f;
    bool in = false;
    if (idx < ce) {
      col = __ldg(indices + idx);
      v = __ldg(vals + idx);
      in = last || col < col_hi;
    }
    const int k = __popc(__ballot_sync(kAll, in));
    gather_entries<kVec4>(s, x, d, col, v, k, ok, c0, lane);
    e += k;
    if (e < ce) break;  // the band ends inside this chunk
    e = cs + 32 + skip;
  }
  if (!last && lane == 0) cursor[slot] = e;
#pragma unroll
  for (int t = 0; t < T::kSlots; ++t) {
    if (!ok[t]) continue;
    float* pw = part + w * d + c0 + (int64_t)(lane + 32 * t) * T::kPer;
#pragma unroll
    for (int q = 0; q < T::kPer; ++q) {
      if (!first) s[t][q] += pw[q];
      pw[q] = s[t][q];
    }
  }
}

// The rows cut into several slices: a block a row, a thread a column, the
// slices' sums added in slice order (deterministic), then into acc.
__global__ void spmm_axpy_join(const int32_t* __restrict__ item_rows,
                               int64_t n_items,
                               const int32_t* __restrict__ split,
                               const float* __restrict__ part, float* acc,
                               int64_t d, float a, float dd) {
  const int64_t w0 = __ldg(split + blockIdx.x);
  const int32_t row = __ldg(item_rows + w0);
  for (int64_t col = threadIdx.x; col < d; col += blockDim.x) {
    float s = 0.f;
    for (int64_t w = w0; w < n_items && __ldg(item_rows + w) == row; ++w)
      s += part[w * d + col];
    float* aw = acc + (int64_t)row * d + col;
    *aw = acc_tail(*aw, s, a, dd);
  }
}

}  // namespace

// Launches K5's short-row kernel on `stream` and returns cudaGetLastError().
// `self` is the shard's own rows (x on one device); `z`, `acc` and `out`
// may be null; `rows` (null: every row) lists the n_rows rows to touch.
// `vec4` requires d % 4 == 0 and every tensor aligned to 16 bytes (checked
// by the Python wrapper).
extern "C" int spmm_axpy_launch(const int64_t* indptr, const int32_t* rows,
                                const int32_t* indices, const float* vals,
                                const float* x, const float* self,
                                const float* z, float* acc, float* out,
                                int64_t n_rows, int64_t d, float a, float b,
                                float c, float dd, int vec4, void* stream) {
  if (n_rows > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t groups = vec4 ? d / 4 : d;
    const int tx = (int)(groups < 256 ? groups : 256);
    const int ty = 256 / tx > 0 ? 256 / tx : 1;
    const dim3 block(tx, ty);
    const dim3 grid((unsigned)((n_rows + ty - 1) / ty));
    if (vec4) {
      spmm_axpy_rows<true><<<grid, block, 0, s>>>(indptr, rows, indices,
                                                  vals, x, self, z, acc, out,
                                                  n_rows, d, a, b, c, dd);
    } else {
      spmm_axpy_rows<false><<<grid, block, 0, s>>>(indptr, rows, indices,
                                                   vals, x, self, z, acc, out,
                                                   n_rows, d, a, b, c, dd);
    }
  }
  return (int)cudaGetLastError();
}

// Launches K5's banded kernel on `stream` (the short-row kernel's contract,
// x's columns in bands of `band` columns, a multiple of 4 when `vec4`, at
// most 256 lanes a row) and returns the first CUDA error.
extern "C" int spmm_axpy_band_launch(const int64_t* indptr,
                                     const int32_t* rows,
                                     const int32_t* indices,
                                     const float* vals, const float* x,
                                     const float* self, const float* z,
                                     float* acc, float* out, int64_t n_rows,
                                     int64_t d, float a, float b, float c,
                                     float dd, int vec4, int64_t band,
                                     void* stream) {
  if (n_rows > 0 && d > 0) {
    if (band <= 0 || (vec4 && band % 4 != 0)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t lanes = vec4 ? band / 4 : band;
    const int64_t bands = (d + band - 1) / band;
    if (lanes > 256 || bands > 65535) return (int)cudaErrorInvalidValue;
    const int ty = (int)(256 / lanes);
    const dim3 block((unsigned)lanes, (unsigned)ty);
    const dim3 grid((unsigned)((n_rows + ty - 1) / ty), (unsigned)bands);
    if (vec4) {
      spmm_axpy_band<true><<<grid, block, 0, s>>>(
          indptr, rows, indices, vals, x, self, z, acc, out, n_rows, d, a, b,
          c, dd, band);
    } else {
      spmm_axpy_band<false><<<grid, block, 0, s>>>(
          indptr, rows, indices, vals, x, self, z, acc, out, n_rows, d, a, b,
          c, dd, band);
    }
  }
  return (int)cudaGetLastError();
}

// Launches K5's long-row kernel on `stream`: acc[row] += dd * a * (A @ x)
// over the rows of a row plan: the n_whole rows `whole`, a warp each, and
// the n_items slices of the rows cut into several (slice w of row
// item_rows[w], cut into item_cuts[w], takes every item_cuts[w]-th chunk
// of 32 entries from item_starts[w] to the row's end; `split` lists the
// first slice of each of the n_split cut rows).  Two launches a band of
// `band_rows` of x's `x_rows` rows (the whole rows, then the slices), then
// spmm_axpy_join.  Returns the first cudaGetLastError() that is not 0.
// Every row's columns must ascend.  With more than one band `cursor` holds
// (n_whole + n_items) * ceil(d / 256) int64, and with more than one band
// or n_items > 0 `part` (n_whole + n_items) * d float32 of scratch
// (neither is read otherwise).
extern "C" int spmm_axpy_long_launch(
    const int64_t* indptr, const int32_t* whole, int64_t n_whole,
    const int32_t* item_rows, const int64_t* item_starts,
    const int32_t* item_cuts, int64_t n_items, const int32_t* split,
    int64_t n_split, const int32_t* indices, const float* vals,
    const float* x, float* acc, int64_t d, float a, float dd, int vec4,
    int64_t x_rows, int64_t band_rows, int64_t* cursor, float* part,
    void* stream) {
  if (n_whole + n_items > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t cols = vec4 ? LongTile<true>::kCols : LongTile<false>::kCols;
    const unsigned tiles = (unsigned)((d + cols - 1) / cols);
    const dim3 grid_whole((unsigned)((n_whole + kLongWarps - 1) / kLongWarps),
                          tiles);
    const dim3 grid_cut((unsigned)((n_items + kLongWarps - 1) / kLongWarps),
                        tiles);
    // the slices' cursors and partial sums follow the whole rows'
    int64_t* cursor_cut = cursor ? cursor + n_whole * tiles : nullptr;
    float* part_cut = part ? part + n_whole * d : nullptr;
    const int64_t bands =
        band_rows >= x_rows ? 1 : (x_rows + band_rows - 1) / band_rows;
    for (int64_t band = 0; band < bands; ++band) {
      const int first = band == 0, last = band == bands - 1;
      const int64_t hi = (band + 1) * band_rows;
      if (n_whole > 0) {
        if (vec4) {
          spmm_axpy_long<true><<<grid_whole, kLongWarps * 32, 0, s>>>(
              indptr, whole, indices, vals, x, x, nullptr, acc, nullptr,
              n_whole, d, a, 0.f, 0.f, dd, hi, first, last, cursor, part);
        } else {
          spmm_axpy_long<false><<<grid_whole, kLongWarps * 32, 0, s>>>(
              indptr, whole, indices, vals, x, x, nullptr, acc, nullptr,
              n_whole, d, a, 0.f, 0.f, dd, hi, first, last, cursor, part);
        }
      }
      if (n_items > 0) {
        if (vec4) {
          spmm_axpy_slices<true><<<grid_cut, kLongWarps * 32, 0, s>>>(
              indptr, item_rows, item_starts, item_cuts, n_items, indices,
              vals, x, d, hi, first, last, cursor_cut, part_cut);
        } else {
          spmm_axpy_slices<false><<<grid_cut, kLongWarps * 32, 0, s>>>(
              indptr, item_rows, item_starts, item_cuts, n_items, indices,
              vals, x, d, hi, first, last, cursor_cut, part_cut);
        }
      }
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (n_split > 0) {
      const int threads = (int)(d < 256 ? (d + 31) / 32 * 32 : 256);
      spmm_axpy_join<<<(unsigned)n_split, threads, 0, s>>>(
          item_rows, n_items, split, part_cut, acc, d, a, dd);
    }
  }
  return (int)cudaGetLastError();
}
