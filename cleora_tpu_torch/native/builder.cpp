// cleora_tpu native graph builder.
//
// C++ equivalent of the reference's Rust ingest core (clique expansion +
// hyperedge trimming + Markov normalization; semantics documented in
// cleora_tpu/graph/builder.py and SURVEY.md §2a N1-N8).  Exposed as a C ABI
// consumed via ctypes (cleora_tpu/graph/native.py).
//
// Pipeline (mirrors the reference's producer/consumer shape, adapted to
// fork-join parallelism):
//   1. parallel line parse + XXH64 token hashing over line ranges
//   2. sequential first-seen hash -> dense index assignment
//   3. row stats (occurrence / row_sum), with the running-occurrence
//      hyperedge-trimming path for sides larger than trim_n
//   4. parallel cartesian pair emission (both directions)
//   5. parallel sort by (row, col), duplicate merge in double precision,
//      left/symmetric Markov normalization
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC -fopenmp

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <new>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#include <parallel/algorithm>
#define PSORT __gnu_parallel::sort
#else
#define PSORT std::sort
#endif

namespace {

// ----------------------------------------------------------------- XXH64
// Bit-exact XXH64 (seed 0), matching twox-hash as used by the reference
// (src/entity.rs:109-114) and cleora_tpu/graph/hashing.py.
constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t read64(const char* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

static inline uint32_t read32(const char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static uint64_t xxh64(const char* data, size_t n, uint64_t seed = 0) {
  const char* p = data;
  const char* end = data + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const char* limit = end - 32;
    do {
      v1 = rotl(v1 + read64(p) * P2, 31) * P1;
      v2 = rotl(v2 + read64(p + 8) * P2, 31) * P1;
      v3 = rotl(v3 + read64(p + 16) * P2, 31) * P1;
      v4 = rotl(v4 + read64(p + 24) * P2, 31) * P1;
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) {
      h ^= rotl(v * P2, 31) * P1;
      h = h * P1 + P4;
    }
  } else {
    h = seed + P5;
  }
  h += (uint64_t)n;
  while (p + 8 <= end) {
    h ^= rotl(read64(p) * P2, 31) * P1;
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(uint8_t)(*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ----------------------------------------------------------------- parsing
struct Token {
  uint64_t hash;
  const char* ptr;  // into the input buffer
  uint32_t len;
  uint8_t col_id;
};

struct Edge {  // one hyperedge's token spans
  int64_t a_off, a_len, b_off, b_len;  // into the worker-local token vector
};

struct ColumnSpec {
  uint8_t complex_;
  uint8_t reflexive;
};

struct WorkerOut {
  std::vector<Token> tokens;
  std::vector<Edge> edges;
  int64_t skipped = 0;
};

// Strict UTF-8 validation (file mode only: iterator input arrives as
// already-valid Python str).  Invalid lines are skipped, matching the
// reference's read_line error handling (src/pipeline.rs:193-218).
static bool utf8_valid(const char* b, const char* e) {
  const unsigned char* p = (const unsigned char*)b;
  const unsigned char* end = (const unsigned char*)e;
  while (p < end) {
    unsigned char c = *p;
    int cont;
    if (c < 0x80) {
      ++p;
      continue;
    } else if ((c & 0xE0) == 0xC0) {
      if (c < 0xC2) return false;  // overlong
      cont = 1;
    } else if ((c & 0xF0) == 0xE0) {
      cont = 2;
    } else if ((c & 0xF8) == 0xF0) {
      if (c > 0xF4) return false;  // > U+10FFFF
      cont = 3;
    } else {
      return false;
    }
    if (end - p <= cont) return false;
    for (int i = 1; i <= cont; ++i)
      if ((p[i] & 0xC0) != 0x80) return false;
    // second-byte range restrictions: reject overlong 3/4-byte forms,
    // UTF-16 surrogates (ED A0-BF), and > U+10FFFF (F4 90+) — Python's
    // .decode('utf-8') rejects these, so accepting them here would turn
    // one bad line into a UnicodeDecodeError aborting the whole ingest
    unsigned char c1 = p[1];
    if ((c == 0xE0 && c1 < 0xA0) ||   // overlong 3-byte
        (c == 0xED && c1 > 0x9F) ||   // surrogate
        (c == 0xF0 && c1 < 0x90) ||   // overlong 4-byte
        (c == 0xF4 && c1 > 0x8F))     // > U+10FFFF
      return false;
    p += cont + 1;
  }
  return true;
}

static inline const char* trim(const char* b, const char*& e) {
  while (b < e && (*b == ' ' || *b == '\t' || *b == '\r')) ++b;
  while (e > b && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r')) --e;
  return b;
}

// Split [b, e) on sep into [start, end) callbacks (keeps empty pieces, like
// Python str.split(sep) / Rust str::split).
template <typename F>
static inline void split(const char* b, const char* e, char sep, F&& fn) {
  const char* s = b;
  for (const char* p = b; p < e; ++p) {
    if (*p == sep) {
      fn(s, p);
      s = p + 1;
    }
  }
  fn(s, e);
}

// Parse one line with the reference's column detection (tab > comma > single;
// src/pipeline.rs:223-240, cleora_tpu columns.parse_line) and append tokens /
// hyperedge spans. Returns false when the column count mismatches.
static bool parse_line(const char* b, const char* e, int ncols,
                       const ColumnSpec* cols, bool reflexive_single,
                       WorkerOut& out) {
  b = trim(b, e);  // whole-line strip; an empty line still parses to a
                   // single empty token in the one-column case (Python
                   // parse_line semantics)

  // collect column ranges
  const char* col_b[64];
  const char* col_e[64];
  int found = 0;
  bool overflow = false;
  char sep = 0;
  for (const char* p = b; p < e; ++p)
    if (*p == '\t') {
      sep = '\t';
      break;
    }
  if (!sep)
    for (const char* p = b; p < e; ++p)
      if (*p == ',') {
        sep = ',';
        break;
      }
  if (sep) {
    split(b, e, sep, [&](const char* s, const char* t) {
      if (found < 64) {
        if (sep == ',') s = trim(s, t);
        col_b[found] = s;
        col_e[found] = t;
      } else {
        overflow = true;
      }
      ++found;
    });
  } else {
    col_b[0] = b;
    col_e[0] = e;
    found = 1;
  }
  if (found != ncols || overflow) return false;

  Edge edge{};
  if (reflexive_single) {
    int64_t off = (int64_t)out.tokens.size();
    split(col_b[0], col_e[0], ' ', [&](const char* s, const char* t) {
      out.tokens.push_back(
          {xxh64(s, (size_t)(t - s)), s, (uint32_t)(t - s), 0});
    });
    int64_t len = (int64_t)out.tokens.size() - off;
    edge = {off, len, off, len};
  } else {
    for (int ci = 0; ci < 2; ++ci) {
      int64_t off = (int64_t)out.tokens.size();
      int emitted = 0;
      split(col_b[ci], col_e[ci], ' ', [&](const char* s, const char* t) {
        if (!cols[ci].complex_ && emitted >= 1) return;  // row[ci][:1]
        out.tokens.push_back(
            {xxh64(s, (size_t)(t - s)), s, (uint32_t)(t - s), (uint8_t)ci});
        ++emitted;
      });
      int64_t len = (int64_t)out.tokens.size() - off;
      if (ci == 0) {
        edge.a_off = off;
        edge.a_len = len;
      } else {
        edge.b_off = off;
        edge.b_len = len;
      }
    }
  }
  out.edges.push_back(edge);
  return true;
}

// (row, col) packed into one sortable 64-bit key; n_entities < 2^31 because
// CSR indices are int32.
struct KV {
  uint64_t key;
  double val;
};

static inline uint64_t pack(int64_t row, int64_t col) {
  return ((uint64_t)row << 32) | (uint32_t)col;
}

// Parallel LSD radix sort of KV by key, 11-bit digits (2048 buckets — small
// enough to stay cache/TLB-resident during the scatter; a 16-bit variant
// degrades ~2x at 100M+ entries).  Stable, deterministic.  Measured on this
// host vs __gnu_parallel::sort: 5x at 13M entries, 22x at 120M (the
// comparison sort collapses to 1.3 M entries/s at spill-run sizes).  Falls
// back to the comparison sort when scratch can't be allocated or
// CLEORA_RADIX=0.
template <typename T, typename KeyFn>
static bool radix_sort_by(T* a, size_t n, int num_workers, KeyFn key) {
  constexpr int BITS = 11;
  constexpr int B = 1 << BITS;
  constexpr uint64_t MASK = B - 1;
  static const bool disabled = [] {
    const char* e = std::getenv("CLEORA_RADIX");
    return e && e[0] == '0';
  }();
  T* tmp = nullptr;
  if (!disabled && n >= (1u << 15))
    tmp = new (std::nothrow) T[n];
  if (!tmp) return false;  // caller falls back to a comparison sort
  int W = std::max(1, num_workers);
  size_t per = (n + W - 1) / W;
  // skip passes above the highest set key bit (row < 2^31 → ≤ 6 passes)
  uint64_t ormask = 0;
  {
    std::vector<uint64_t> part((size_t)W, 0);
    std::vector<std::thread> th;
    for (int w = 0; w < W; ++w)
      th.emplace_back([&, w] {
        uint64_t m = 0;
        size_t lo = std::min(n, (size_t)w * per), hi = std::min(n, lo + per);
        for (size_t i = lo; i < hi; ++i) m |= key(a[i]);
        part[(size_t)w] = m;
      });
    for (auto& t : th) t.join();
    for (int w = 0; w < W; ++w) ormask |= part[(size_t)w];
  }
  int need = 1;
  while ((ormask >> need) && need < 64) ++need;
  int passes = (need + BITS - 1) / BITS;
  T* src = a;
  T* dst = tmp;
  std::vector<std::vector<size_t>> hist((size_t)W,
                                        std::vector<size_t>(B));
  for (int p = 0; p < passes; ++p) {
    int shift = p * BITS;
    {
      std::vector<std::thread> th;
      for (int w = 0; w < W; ++w)
        th.emplace_back([&, w] {
          auto& h = hist[(size_t)w];
          std::fill(h.begin(), h.end(), 0);
          size_t lo = std::min(n, (size_t)w * per);
          size_t hi = std::min(n, lo + per);
          for (size_t i = lo; i < hi; ++i)
            ++h[(key(src[i]) >> shift) & MASK];
        });
      for (auto& t : th) t.join();
    }
    size_t sum = 0;  // exclusive prefix over (digit, worker): stable order
    for (int d = 0; d < B; ++d)
      for (int w = 0; w < W; ++w) {
        size_t c = hist[(size_t)w][(size_t)d];
        hist[(size_t)w][(size_t)d] = sum;
        sum += c;
      }
    {
      std::vector<std::thread> th;
      for (int w = 0; w < W; ++w)
        th.emplace_back([&, w] {
          auto& h = hist[(size_t)w];
          size_t lo = std::min(n, (size_t)w * per);
          size_t hi = std::min(n, lo + per);
          for (size_t i = lo; i < hi; ++i)
            dst[h[(key(src[i]) >> shift) & MASK]++] = src[i];
        });
      for (auto& t : th) t.join();
    }
    std::swap(src, dst);
  }
  if (src != a) std::memcpy(a, src, n * sizeof(T));
  delete[] tmp;
  return true;
}

static void sort_kv_by_key(KV* a, size_t n, int num_workers) {
  if (!radix_sort_by(a, n, num_workers, [](const KV& x) { return x.key; }))
    PSORT(a, a + n, [](const KV& x, const KV& y) { return x.key < y.key; });
}

// Open-addressing hash table (linear probing, identity hash — XXH64 keys are
// already well mixed).  ~6x faster than std::unordered_map on this workload.
struct FirstSeenTable {
  std::vector<uint64_t> keys;
  std::vector<int64_t> vals;  // -1 = empty
  uint64_t mask;

  explicit FirstSeenTable(size_t expected) {
    size_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    keys.resize(cap);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  // returns (index, inserted)
  inline std::pair<int64_t, bool> insert(uint64_t h, int64_t next_index) {
    uint64_t slot = h & mask;
    for (;;) {
      int64_t v = vals[slot];
      if (v == -1) {
        keys[slot] = h;
        vals[slot] = next_index;
        return {next_index, true};
      }
      if (keys[slot] == h) return {v, false};
      slot = (slot + 1) & mask;
    }
  }
};

struct BuildResult {
  std::vector<std::string> owned_buffers;  // file contents (id_ptr aliases)
  std::vector<const char*> id_ptr;
  std::vector<uint32_t> id_len;
  std::vector<uint64_t> hashes;
  std::vector<uint8_t> column_ids;
  std::vector<float> row_sums;
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<float> left_vals;
  std::vector<float> sym_vals;
  int64_t skipped = 0;
  std::string error;
};

static void emit_cartesian(const int64_t* a, int64_t an, const int64_t* b,
                           int64_t bn, double val, std::vector<KV>& pairs) {
  for (int64_t i = 0; i < an; ++i)
    for (int64_t j = 0; j < bn; ++j) {
      pairs.push_back({pack(a[i], b[j]), val});
      pairs.push_back({pack(b[j], a[i]), val});
    }
}

struct Buf {
  const char* data;
  int64_t len;
};

static BuildResult* build(BuildResult* res, const std::vector<Buf>& bufs,
                          int ncols, const ColumnSpec* cols, int trim_n,
                          int num_workers, bool skip_empty) {
  const bool debug = std::getenv("CLEORA_NATIVE_DEBUG") != nullptr;
  auto now = [] {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  double t0 = now();
  auto lap = [&](const char* what) {
    if (debug) {
      std::fprintf(stderr, "[native] %-12s %.3fs\n", what, now() - t0);
      t0 = now();
    }
  };
  bool reflexive_single = (ncols == 1);
  if (num_workers <= 0)
    num_workers = (int)std::max(1u, std::thread::hardware_concurrency());

  // ---- collect line ranges.  Iterator mode keeps empty lines (Python
  // parse_line registers an empty token for them in the single-column case);
  // file mode skips them (SparseMatrix.from_files filters blank lines).
  std::vector<std::pair<const char*, const char*>> lines;
  for (const Buf& b : bufs) {
    split(b.data, b.data + b.len, '\n', [&](const char* s, const char* t) {
      if (!skip_empty || t > s) lines.emplace_back(s, t);
    });
  }
  int64_t n_lines = (int64_t)lines.size();

  // ---- phase 1: parallel parse + hash
  int W = (int)std::min<int64_t>(num_workers, std::max<int64_t>(1, n_lines));
  std::vector<WorkerOut> outs(W);
  {
    std::vector<std::thread> threads;
    int64_t chunk = (n_lines + W - 1) / W;
    for (int w = 0; w < W; ++w) {
      threads.emplace_back([&, w] {
        int64_t lo = std::min(n_lines, w * chunk);
        int64_t hi = std::min(n_lines, lo + chunk);
        auto& out = outs[w];
        out.tokens.reserve((size_t)(hi - lo) * 4);
        out.edges.reserve((size_t)(hi - lo));
        for (int64_t i = lo; i < hi; ++i) {
          // file mode (skip_empty): raw bytes may be invalid UTF-8 —
          // skip such lines like the reference's read_line error path
          if (skip_empty && !utf8_valid(lines[i].first, lines[i].second)) {
            ++out.skipped;
            continue;
          }
          if (!parse_line(lines[i].first, lines[i].second, ncols, cols,
                          reflexive_single, out))
            ++out.skipped;
        }
      });
    }
    for (auto& t : threads) t.join();
  }
  lap("parse+hash");

  // stitch worker outputs (token offsets shift per worker)
  std::vector<Token> tokens;
  std::vector<Edge> edges;
  {
    size_t tot_t = 0, tot_e = 0;
    for (auto& o : outs) {
      tot_t += o.tokens.size();
      tot_e += o.edges.size();
      res->skipped += o.skipped;
    }
    tokens.reserve(tot_t);
    edges.reserve(tot_e);
    for (auto& o : outs) {
      int64_t base = (int64_t)tokens.size();
      tokens.insert(tokens.end(), o.tokens.begin(), o.tokens.end());
      for (auto e : o.edges) {
        e.a_off += base;
        e.b_off += base;
        edges.push_back(e);
      }
      o.tokens.clear();
      o.tokens.shrink_to_fit();
    }
  }
  if (tokens.empty()) {
    res->error = "No valid hyperedge lines provided";
    return res;
  }

  // ---- phase 2: first-seen dense indexing, sort-based (parallel):
  // sort (hash, pos); groups share a hash; group rank = order of min pos.
  int64_t n_tok = (int64_t)tokens.size();
  // write-once buffers stay UNINITIALIZED (new T[] default-init for PODs):
  // zero-initializing gigabytes serially is the hot spot on hosts with lazy
  // first-touch page backing; filling from worker threads both skips the
  // redundant memset and faults the pages in parallel.
  std::unique_ptr<int64_t[]> tok_index(new int64_t[(size_t)n_tok]);
  int64_t n_entities = 0;
  {
    struct HP {
      uint64_t hash;
      int64_t pos;
    };
    std::unique_ptr<HP[]> hp(new HP[(size_t)n_tok]);
    {
      int Wf = (int)std::min<int64_t>(num_workers, std::max<int64_t>(1, n_tok));
      std::vector<std::thread> threads;
      int64_t chunk = (n_tok + Wf - 1) / Wf;
      for (int w = 0; w < Wf; ++w)
        threads.emplace_back([&, w] {
          int64_t lo = std::min(n_tok, w * chunk);
          int64_t hi = std::min(n_tok, lo + chunk);
          for (int64_t i = lo; i < hi; ++i)
            hp[(size_t)i] = {tokens[(size_t)i].hash, i};
        });
      for (auto& t : threads) t.join();
    }
    // stable radix by hash: hp[] is filled with pos ascending, so equal
    // hashes stay pos-ordered — identical to the (hash, pos) comparison
    if (!radix_sort_by(hp.get(), (size_t)n_tok, num_workers,
                       [](const HP& x) { return x.hash; }))
      PSORT(hp.get(), hp.get() + n_tok, [](const HP& x, const HP& y) {
        return x.hash != y.hash ? x.hash < y.hash : x.pos < y.pos;
      });
    // group starts and first positions
    std::vector<int64_t> group_start;
    group_start.reserve((size_t)n_tok / 2);
    for (int64_t i = 0; i < n_tok; ++i)
      if (i == 0 || hp[(size_t)i].hash != hp[(size_t)i - 1].hash)
        group_start.push_back(i);
    n_entities = (int64_t)group_start.size();
    // rank groups by first-seen position
    std::vector<int64_t> order((size_t)n_entities);
    for (int64_t g = 0; g < n_entities; ++g) order[(size_t)g] = g;
    PSORT(order.begin(), order.end(), [&](int64_t x, int64_t y) {
      return hp[(size_t)group_start[(size_t)x]].pos <
             hp[(size_t)group_start[(size_t)y]].pos;
    });
    std::vector<int64_t> rank((size_t)n_entities);
    for (int64_t r = 0; r < n_entities; ++r) rank[(size_t)order[(size_t)r]] = r;
    // entity table in rank order
    res->id_ptr.resize((size_t)n_entities);
    res->id_len.resize((size_t)n_entities);
    res->hashes.resize((size_t)n_entities);
    res->column_ids.resize((size_t)n_entities);
    for (int64_t g = 0; g < n_entities; ++g) {
      const Token& t = tokens[(size_t)hp[(size_t)group_start[(size_t)g]].pos];
      int64_t r = rank[(size_t)g];
      res->id_ptr[(size_t)r] = t.ptr;
      res->id_len[(size_t)r] = t.len;
      res->hashes[(size_t)r] = t.hash;
      res->column_ids[(size_t)r] = t.col_id;
    }
    // scatter tok_index (parallel-friendly contiguous walk)
    for (int64_t g = 0; g < n_entities; ++g) {
      int64_t lo = group_start[(size_t)g];
      int64_t hi = g + 1 < n_entities ? group_start[(size_t)g + 1] : n_tok;
      int64_t r = rank[(size_t)g];
      for (int64_t i = lo; i < hi; ++i) tok_index[(size_t)hp[(size_t)i].pos] = r;
    }
  }
  lap("index");

#if defined(_OPENMP)
  omp_set_num_threads(num_workers);
#endif

  // ---- phase 3+4: row stats, trimming, pair emission
  int64_t n_edges_in = (int64_t)edges.size();
  bool has_big = false;
  for (auto& e : edges)
    if (e.a_len > trim_n || e.b_len > trim_n) {
      has_big = true;
      break;
    }

  std::vector<double> row_sum(n_entities, 0.0);
  std::vector<KV> pairs;          // trimming path (push_back)
  std::unique_ptr<KV[]> pairs_raw;  // fast path (uninitialized, write-once)
  KV* pr = nullptr;
  size_t n_pairs = 0;

  if (!has_big) {
    // Fast path: no trimming anywhere -> no running occurrence counts needed;
    // row stats reduce over per-thread partials and pair emission fills
    // preallocated slots via a prefix sum -- fully parallel.
    std::vector<int64_t> offsets(n_edges_in + 1, 0);
    for (int64_t i = 0; i < n_edges_in; ++i)
      offsets[i + 1] = offsets[i] + edges[i].a_len * edges[i].b_len * 2;
    lap("pairs:offs");
    n_pairs = (size_t)offsets[n_edges_in];
    pairs_raw.reset(new KV[n_pairs]);  // no zero pass; workers write every slot
    pr = pairs_raw.get();
    lap("pairs:alloc");

    int W2 = num_workers;
    std::vector<std::vector<double>> partials(
        (size_t)W2, std::vector<double>((size_t)n_entities, 0.0));
    lap("pairs:partial");
    {
      std::vector<std::thread> threads;
      int64_t chunk = (n_edges_in + W2 - 1) / W2;
      for (int w = 0; w < W2; ++w) {
        threads.emplace_back([&, w] {
          int64_t lo = std::min(n_edges_in, w * chunk);
          int64_t hi = std::min(n_edges_in, lo + chunk);
          auto& rs = partials[(size_t)w];
          for (int64_t ei = lo; ei < hi; ++ei) {
            const Edge& e = edges[(size_t)ei];
            double inv_b = (double)(1.0f / (float)e.b_len);
            double inv_a = (double)(1.0f / (float)e.a_len);
            double val = (double)(float)(1.0 / (double)(e.a_len * e.b_len));
            KV* out = pr + offsets[ei];
            for (int64_t i = 0; i < e.a_len; ++i) {
              int64_t a = tok_index[e.a_off + i];
              rs[(size_t)a] += inv_b;
              for (int64_t j = 0; j < e.b_len; ++j) {
                int64_t b = tok_index[e.b_off + j];
                *out++ = {pack(a, b), val};
                *out++ = {pack(b, a), val};
              }
            }
            for (int64_t j = 0; j < e.b_len; ++j)
              rs[(size_t)tok_index[e.b_off + j]] += inv_a;
          }
        });
      }
      for (auto& t : threads) t.join();
    }
    for (int w = 0; w < W2; ++w) {
      const auto& rs = partials[(size_t)w];
      for (int64_t i = 0; i < n_entities; ++i)
        row_sum[(size_t)i] += rs[(size_t)i];
    }
  } else {
    // Trimming path: running occurrence counts make this inherently
    // sequential in input order (reference semantics,
    // src/sparse_matrix_builder.rs:188-207).
    std::vector<int64_t> occurrence((size_t)n_entities, 0);
    {
      size_t est = 0;
      for (auto& e : edges) {
        int64_t an = std::min<int64_t>(e.a_len, trim_n + 8);
        int64_t bn = std::min<int64_t>(e.b_len, trim_n + 8);
        est += (size_t)(an * bn) * 2;
      }
      pairs.reserve(est);
    }
    std::vector<int64_t> hi_a, lo_a, hi_b, lo_b, order;
    for (auto& e : edges) {
      if (e.a_len == 0 || e.b_len == 0) continue;
      // row stats first (reference updates rows before trimming)
      double inv_b = (double)(1.0f / (float)e.b_len);
      double inv_a = (double)(1.0f / (float)e.a_len);
      for (int64_t i = 0; i < e.a_len; ++i) {
        int64_t n = tok_index[e.a_off + i];
        occurrence[(size_t)n] += e.b_len;
        row_sum[(size_t)n] += inv_b;
      }
      for (int64_t i = 0; i < e.b_len; ++i) {
        int64_t n = tok_index[e.b_off + i];
        occurrence[(size_t)n] += e.a_len;
        row_sum[(size_t)n] += inv_a;
      }

      double val = (double)(float)(1.0 / (double)(e.a_len * e.b_len));

      auto trim_side = [&](int64_t off, int64_t len, std::vector<int64_t>& hi,
                           std::vector<int64_t>& lo) {
        hi.clear();
        lo.clear();
        if (len <= trim_n) {
          for (int64_t i = 0; i < len; ++i) hi.push_back(tok_index[off + i]);
          return;
        }
        order.resize((size_t)len);
        for (int64_t i = 0; i < len; ++i) order[(size_t)i] = i;
        std::stable_sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
          return occurrence[(size_t)tok_index[off + x]] >
                 occurrence[(size_t)tok_index[off + y]];
        });
        for (int64_t i = 0; i < len; ++i) {
          int64_t n = tok_index[off + order[(size_t)i]];
          (i < trim_n ? hi : lo).push_back(n);
        }
      };

      if (e.a_len <= trim_n && e.b_len <= trim_n) {
        for (int64_t i = 0; i < e.a_len; ++i) {
          int64_t a = tok_index[e.a_off + i];
          for (int64_t j = 0; j < e.b_len; ++j) {
            int64_t b = tok_index[e.b_off + j];
            pairs.push_back({pack(a, b), val});
            pairs.push_back({pack(b, a), val});
          }
        }
      } else {
        trim_side(e.a_off, e.a_len, hi_a, lo_a);
        trim_side(e.b_off, e.b_len, hi_b, lo_b);
        emit_cartesian(hi_a.data(), (int64_t)hi_a.size(), hi_b.data(),
                       (int64_t)hi_b.size(), val, pairs);
        emit_cartesian(hi_a.data(), (int64_t)hi_a.size(), lo_b.data(),
                       (int64_t)lo_b.size(), val, pairs);
        emit_cartesian(lo_a.data(), (int64_t)lo_a.size(), hi_b.data(),
                       (int64_t)hi_b.size(), val, pairs);
      }
    }
  }
  if (!pr) {  // trimming path built a vector
    pr = pairs.data();
    n_pairs = pairs.size();
  }
  lap("pairs");

  // ---- phase 5: sort by packed key, merge duplicates, normalize
  sort_kv_by_key(pr, n_pairs, num_workers);
  lap("sort");

  res->indptr.assign((size_t)n_entities + 1, 0);
  size_t np = n_pairs;
  res->indices.reserve(np / 2);
  res->left_vals.reserve(np / 2);
  res->sym_vals.reserve(np / 2);
  for (size_t i = 0; i < np;) {
    uint64_t k = pr[i].key;
    double s = 0.0;
    while (i < np && pr[i].key == k) s += pr[i++].val;
    size_t r = (size_t)(k >> 32);
    size_t c = (size_t)(uint32_t)k;
    res->indices.push_back((int32_t)c);
    res->left_vals.push_back((float)(s / row_sum[r]));
    res->sym_vals.push_back((float)(s / std::sqrt(row_sum[r] * row_sum[c])));
    ++res->indptr[r + 1];
  }
  for (int64_t i = 0; i < n_entities; ++i) res->indptr[i + 1] += res->indptr[i];
  lap("merge");

  res->row_sums.resize((size_t)n_entities);
  for (int64_t i = 0; i < n_entities; ++i)
    res->row_sums[(size_t)i] = (float)row_sum[(size_t)i];
  return res;
}

}  // namespace

// ------------------------------------------------------------------- C ABI
extern "C" {

// An exception (bad_alloc, primarily) escaping these extern "C" frames
// would std::terminate Python; convert to the handle error string (or a
// null handle when even the result struct can't be allocated).
static void* build_fail(BuildResult* res) {
  if (!res) return nullptr;
  try {
    if (res->error.empty()) res->error = "out of memory during graph build";
  } catch (...) {
  }
  return res;
}

void* ct_build(const char* buf, int64_t buf_len, int ncols,
               const uint8_t* complex_flags, const uint8_t* reflexive_flags,
               int trim_n, int num_workers) {
  BuildResult* res = nullptr;
  try {
    ColumnSpec cols[64];
    for (int i = 0; i < ncols && i < 64; ++i)
      cols[i] = {complex_flags[i], reflexive_flags[i]};
    res = new BuildResult();
    return build(res, {{buf, buf_len}}, ncols, cols, trim_n, num_workers,
                 /*skip_empty=*/false);
  } catch (...) {
    return build_fail(res);
  }
}

// Reads the files itself (parallel reader threads, reference
// src/pipeline.rs:81-152 shape) and runs the same pipeline.  Unreadable
// files are skipped (counted in ct_skipped_lines is NOT affected; they are
// reported via ct_error only if nothing could be read).
void* ct_build_files(const char** paths, int n_files, int ncols,
                     const uint8_t* complex_flags,
                     const uint8_t* reflexive_flags, int trim_n,
                     int num_workers) {
  BuildResult* res = nullptr;
  try {
  ColumnSpec cols[64];
  for (int i = 0; i < ncols && i < 64; ++i)
    cols[i] = {complex_flags[i], reflexive_flags[i]};
  res = new BuildResult();
  res->owned_buffers.resize((size_t)n_files);
  {
    int readers = std::min(n_files, 4);
    std::vector<std::thread> threads;
    std::atomic<int> next(0);
    for (int t = 0; t < readers; ++t) {
      threads.emplace_back([&] {
        for (;;) {
          int i = next.fetch_add(1);
          if (i >= n_files) break;
          FILE* f = std::fopen(paths[i], "rb");
          if (!f) continue;
          try {  // a bad_alloc here would terminate (thread boundary) —
            // treat an unloadable file like an unreadable one (skipped)
            std::fseek(f, 0, SEEK_END);
            long sz = std::ftell(f);
            std::fseek(f, 0, SEEK_SET);
            std::string& s = res->owned_buffers[(size_t)i];
            s.resize((size_t)std::max(0L, sz));
            size_t got = sz > 0 ? std::fread(&s[0], 1, (size_t)sz, f) : 0;
            s.resize(got);
          } catch (...) {
            res->owned_buffers[(size_t)i].clear();
          }
          std::fclose(f);
        }
      });
    }
    for (auto& th : threads) th.join();
  }
  std::vector<Buf> bufs;
  for (auto& s : res->owned_buffers)
    bufs.push_back({s.data(), (int64_t)s.size()});
  return build(res, bufs, ncols, cols, trim_n, num_workers,
               /*skip_empty=*/true);
  } catch (...) {
    return build_fail(res);
  }
}

const char* ct_error(void* h) {
  auto* r = (BuildResult*)h;
  return r->error.empty() ? nullptr : r->error.c_str();
}

int64_t ct_num_entities(void* h) {
  return (int64_t)((BuildResult*)h)->hashes.size();
}

int64_t ct_num_edges(void* h) {
  return (int64_t)((BuildResult*)h)->indices.size();
}

int64_t ct_skipped_lines(void* h) { return ((BuildResult*)h)->skipped; }

// Copy fixed-width arrays out.  id strings: lengths via ct_id_lens, bytes
// concatenated via ct_id_bytes (caller sizes the blob from the lengths).
void ct_get_arrays(void* h, uint64_t* hashes, uint8_t* column_ids,
                   float* row_sums, int64_t* indptr, int32_t* indices,
                   float* left_vals, float* sym_vals) {
  auto* r = (BuildResult*)h;
  std::memcpy(hashes, r->hashes.data(), r->hashes.size() * 8);
  std::memcpy(column_ids, r->column_ids.data(), r->column_ids.size());
  std::memcpy(row_sums, r->row_sums.data(), r->row_sums.size() * 4);
  std::memcpy(indptr, r->indptr.data(), r->indptr.size() * 8);
  std::memcpy(indices, r->indices.data(), r->indices.size() * 4);
  std::memcpy(left_vals, r->left_vals.data(), r->left_vals.size() * 4);
  std::memcpy(sym_vals, r->sym_vals.data(), r->sym_vals.size() * 4);
}

void ct_id_lens(void* h, uint32_t* lens) {
  auto* r = (BuildResult*)h;
  std::memcpy(lens, r->id_len.data(), r->id_len.size() * 4);
}

void ct_id_bytes(void* h, char* blob) {
  auto* r = (BuildResult*)h;
  for (size_t i = 0; i < r->id_ptr.size(); ++i) {
    std::memcpy(blob, r->id_ptr[i], r->id_len[i]);
    blob += r->id_len[i];
  }
}

void ct_free(void* h) { delete (BuildResult*)h; }

// In-place parallel sort of a uint64 key array (the 2048-bucket LSD radix
// core above; comparison-sort fallback when scratch allocation fails or
// CLEORA_RADIX=0).  Exposed for host-side sort-reduce stages that operate
// on packed (row·n + col) keys — e.g. the random-walk windowed
// co-occurrence counting (algorithms.py), where this replaces numpy's
// single-threaded comparison sort.  Returns 1 if the radix path ran.
int ct_sort_u64(uint64_t* a, int64_t n, int num_workers) {
  if (n <= 1) return 1;
  if (num_workers <= 0)
    num_workers = (int)std::thread::hardware_concurrency();
  try {
    if (radix_sort_by(a, (size_t)n, num_workers,
                      [](const uint64_t& x) { return x; }))
      return 1;
  } catch (...) {
  }
  PSORT(a, a + n);
  return 0;
}

}  // extern "C"

// Out-of-core streaming build (same translation unit: reuses the parser,
// hashing, trimming and KV machinery above).
#include "stream.cpp"
