// One hop of the second-order (Node2Vec p/q) walk, shared by K12
// (walk_p_q.cu: every row on one card) and K18 (walk2_owned.cu: rows cut
// into slices), so that the two cannot drift apart.
//
// The hop from a current row with degree d > 0 (K12's file comment has
// the formulas):
//
//   head     w_bt = vals[pos(prev in row cur)] * inv_p (0 on the first hop),
//            m2 = max(1, inv_q), env = w_bt + (float(d) * wmax) * m2,
//            pi = w_bt / max(env, 1e-30), cap = max(wmax * m2, 1e-30),
//            dead = wsum * m2 + w_bt < 1e-15
//   round r  Philox4x32-10 at counter (g lo, g hi, h, r + 1): u0, u1, u2;
//            backtrack when not first and u0 < pi; otherwise the proposal
//            x = cols[lo + min(int(u1 * float(d)), d - 1)], taken on the
//            first hop or the last round, else accepted when
//            u2 < (w * alpha) / cap (alpha 0 for x == prev, 1 for a common
//            neighbour of prev and cur, inv_q otherwise).
//
// Every float operation is a round-to-nearest intrinsic (never contracted
// into an FMA) in this order, and ops/walk.py's plain versions repeat it,
// so the walks are bitwise the same on the card and on the CPU.  A row is
// addressed by its index into the tables the caller passes: the global
// node on one card, the row within a slice under K18.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace walk2 {

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

// The three uniforms of round `rnd` of hop `hop` of walk g.
struct Uniforms {
  float u0, u1, u2;
};

__device__ __forceinline__ Uniforms round_uniforms(uint64_t g, int hop,
                                                   int rnd, uint32_t k0,
                                                   uint32_t k1) {
  uint32_t x[4];
  philox4((uint32_t)g, (uint32_t)(g >> 32), (uint32_t)hop,
          (uint32_t)(rnd + 1), k0, k1, x);
  return {unit_float(x[0]), unit_float(x[1]), unit_float(x[2])};
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

// Whether x is a column of [lo, hi).
__device__ __forceinline__ bool in_row(const int32_t* __restrict__ cols,
                                       int32_t lo, int32_t hi, int32_t x) {
  const int32_t pos = lower_bound(cols, lo, hi, x);
  return pos < hi && __ldg(cols + pos) == x;
}

// The terms of a hop that follow from d, wmax and w_bt.
struct Terms {
  float pi, cap;
};

__device__ __forceinline__ Terms hop_terms(int32_t d, float wm, float w_bt,
                                           float inv_q) {
  const float m2 = fmaxf(1.0f, inv_q);
  const float env =
      __fadd_rn(w_bt, __fmul_rn(__fmul_rn(__int2float_rn(d), wm), m2));
  return {__fdiv_rn(w_bt, fmaxf(env, 1e-30f)),
          fmaxf(__fmul_rn(wm, m2), 1e-30f)};
}

// The head of a hop from row `row` (valid, any degree): its first entry,
// degree, wmax, backtrack weight (0 when `first`) and whether it is dead.
struct Head {
  int32_t lo, d;
  float wm, w_bt;
  bool dead;
};

__device__ __forceinline__ Head hop_head(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols,
    const float* __restrict__ vals, const int32_t* __restrict__ deg,
    const float* __restrict__ wmax, const float* __restrict__ wsum,
    int64_t row, int32_t prev, bool first, float inv_p, float inv_q) {
  Head t;
  t.d = __ldg(deg + row);
  t.lo = __ldg(indptr + row);
  t.wm = __ldg(wmax + row);
  t.w_bt = 0.0f;
  t.dead = true;
  if (t.d > 0) {
    if (!first) {
      const int32_t pos = lower_bound(cols, t.lo, t.lo + t.d, prev);
      if (pos < t.lo + t.d && __ldg(cols + pos) == prev)
        t.w_bt = __fmul_rn(__ldg(vals + pos), inv_p);
    }
    t.dead = __fadd_rn(__fmul_rn(__ldg(wsum + row), fmaxf(1.0f, inv_q)),
                       t.w_bt) < 1e-15f;
  }
  return t;
}

// The proposal's entry of a round: lo + min(int(u1 * float(d)), d - 1).
__device__ __forceinline__ int32_t proposal(int32_t lo, int32_t d, float u1) {
  int32_t j = (int32_t)__fmul_rn(u1, __int2float_rn(d));
  if (j > d - 1) j = d - 1;
  return lo + j;
}

// The acceptance test of a proposal of weight w.
__device__ __forceinline__ bool accepts(float u2, float w, float alpha,
                                        float cap) {
  return u2 < __fdiv_rn(__fmul_rn(w, alpha), cap);
}

// The whole hop of walk g from row `row` (valid) with the head `t`: the
// next node, or n for a row of degree 0 or a dead row.  `prev_row` is the
// row of `prev` in the same tables (read only when not `first`).
__device__ __forceinline__ int32_t hop(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols,
    const float* __restrict__ vals, const int32_t* __restrict__ deg,
    const Head& t, int32_t prev, int64_t prev_row, bool first, uint64_t g,
    int h, uint32_t k0, uint32_t k1, int32_t n, float inv_q, int tries) {
  if (t.d <= 0 || t.dead) return n;
  const Terms s = hop_terms(t.d, t.wm, t.w_bt, inv_q);
  int32_t plo = 0, phi = 0;
  if (!first) {
    plo = __ldg(indptr + prev_row);
    phi = plo + __ldg(deg + prev_row);
  }
  int32_t nxt = n;
  for (int r = 0; r < tries; ++r) {
    const Uniforms u = round_uniforms(g, h, r, k0, k1);
    if (!first && u.u0 < s.pi) {
      nxt = prev;
      break;
    }
    const int32_t e = proposal(t.lo, t.d, u.u1);
    const int32_t cand = __ldg(cols + e);
    if (first || r == tries - 1) {
      nxt = cand;
      break;
    }
    const float alpha =
        cand == prev ? 0.0f : (in_row(cols, plo, phi, cand) ? 1.0f : inv_q);
    if (accepts(u.u2, __ldg(vals + e), alpha, s.cap)) {
      nxt = cand;
      break;
    }
  }
  return nxt;
}

// ---- K12's form: one 16-byte head record a row and window lookups.
//
// The head record of a row holds (first entry, degree, wmax, wsum) as
// int32, int32, float32 bits, float32 bits (kernels.walk_head), so a hop
// reads one sector for what the four arrays above take four.  A walk's
// lane loads kWindow entries of cols, from the row's first entry rounded
// down to 4, in 16-byte loads that are all in flight at once, and finds the
// first position whose column is >= x by a scan of its registers.  A row
// longer than the window is narrowed by lower_bound's steps until the
// window covers what is left.  The position found is lower_bound's, and
// the column there is tested against x.

constexpr int kWindow = 32;  // entries of a window load

struct Window {
  int32_t base;            // the window's first entry (a multiple of 4)
  int4 v[kWindow / 4];     // entries base + 4 i .. base + 4 i + 3
};

// Whether [lo, hi) lies in the window that starts at lo rounded down to 4.
__device__ __forceinline__ bool window_holds(int32_t lo, int32_t hi) {
  return hi <= (lo & ~3) + kWindow;
}

// The window at lo rounded down to 4; only the loads that meet [lo, hi)
// are made (an aligned 16-byte load that holds an entry of cols stays
// inside it).
__device__ __forceinline__ Window load_window(
    const int32_t* __restrict__ cols, int32_t lo, int32_t hi) {
  Window w;
  w.base = lo & ~3;
#pragma unroll
  for (int i = 0; i < kWindow / 4; ++i) {
    const int32_t at = w.base + 4 * i;
    w.v[i] = at < hi ? __ldg(reinterpret_cast<const int4*>(cols + at))
                     : make_int4(0, 0, 0, 0);
  }
  return w;
}

__device__ __forceinline__ int32_t lane_of(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The first position in [lo, hi) (inside the window) whose column is >= x,
// and whether that column is x: `pos` is hi when there is none.
struct Found {
  int32_t pos;
  bool hit;
};

__device__ __forceinline__ Found window_find(const Window& w, int32_t lo,
                                             int32_t hi, int32_t x) {
  Found f{hi, false};
#pragma unroll
  for (int i = kWindow / 4 - 1; i >= 0; --i) {
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      const int32_t at = w.base + 4 * i + j;
      const int32_t col = lane_of(w.v[i], j);
      if (at >= lo && at < hi && col >= x) f = {at, col == x};
    }
  }
  return f;
}

// window_find in a row [lo, end) of any length.  lower_bound's steps keep
// its answer in [lo, hi], and cols[hi] >= x when hi < end, so the window
// must hold [lo, min(hi + 1, end)) for the test of that column.
__device__ __forceinline__ Found row_find(const int32_t* __restrict__ cols,
                                          int32_t lo, int32_t end,
                                          int32_t x) {
  int32_t hi = end;
  while (!window_holds(lo, hi < end ? hi + 1 : end)) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(cols + mid) < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  hi = hi < end ? hi + 1 : end;
  return window_find(load_window(cols, lo, hi), lo, hi, x);
}

}  // namespace walk2
