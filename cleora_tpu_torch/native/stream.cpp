// Out-of-core (streaming) graph build: bounded-RAM ingest for graphs whose
// pair stream exceeds memory (reference analogs: streaming file pipeline
// the reference's src/pipeline.rs:81-104 and the legacy mmap persistence
// the reference's legacy/src/persistence.rs; scale target BASELINE.json 1B+
// edges).
//
// Shape: the caller feeds newline-terminated text chunks (or raw integer
// pair arrays) in order.  Per chunk: parallel parse+hash, then a SEQUENTIAL
// incremental first-seen indexer + row stats + trimming + pair emission —
// sequential order is what makes the result match the in-RAM builder
// (first-seen entity order and the running-occurrence trimming are
// input-order-dependent, src/sparse_matrix_builder.rs:188-207).  Caveat on
// "bitwise": a duplicate (row,col) pair whose occurrences straddle a spill
// -run boundary is summed as per-run f64 partials added at merge time —
// a different grouping than the in-RAM sequential sum, so at most-extreme
// scales a value can differ by an f64 ULP before the final f32 rounding
// (every tested input rounds identically; the tests assert allclose at
// 1e-7 on values and exact equality on structure).
// Emitted (row,col,val) pairs accumulate in a bounded buffer; at the cap the
// buffer is sorted, duplicate-summed (f64) and spilled as a sorted run.
// finish() k-way-merges the runs and streams the final CSR
// (indices/left/sym) straight to disk files; only the entity table,
// row_sums, indptr and bounded buffers ever live in RAM.
//
// This file is #included into builder.cpp (single translation unit — it
// reuses xxh64 / parse_line / KV / pack / PSORT / trim-side logic).

namespace {

struct GrowTable {
  // FirstSeenTable with growth (streaming can't pre-size).
  std::vector<uint64_t> keys;
  std::vector<int64_t> vals;
  uint64_t mask;
  size_t used = 0;

  GrowTable() : keys(1 << 16), vals(1 << 16, -1), mask((1 << 16) - 1) {}

  void grow() {
    size_t ncap = keys.size() * 2;
    std::vector<uint64_t> nk(ncap);
    std::vector<int64_t> nv(ncap, -1);
    uint64_t nm = ncap - 1;
    for (size_t i = 0; i < keys.size(); ++i) {
      if (vals[i] == -1) continue;
      uint64_t slot = keys[i] & nm;
      while (nv[slot] != -1) slot = (slot + 1) & nm;
      nk[slot] = keys[i];
      nv[slot] = vals[i];
    }
    keys.swap(nk);
    vals.swap(nv);
    mask = nm;
  }

  inline std::pair<int64_t, bool> insert(uint64_t h, int64_t next_index) {
    if (used * 2 >= keys.size()) grow();
    uint64_t slot = h & mask;
    for (;;) {
      int64_t v = vals[slot];
      if (v == -1) {
        keys[slot] = h;
        vals[slot] = next_index;
        ++used;
        return {next_index, true};
      }
      if (keys[slot] == h) return {v, false};
      slot = (slot + 1) & mask;
    }
  }
};

struct RunEntry {
  uint64_t key;
  double val;
};

// row_sum and occurrence interleaved: every edge updates both for the same
// entity, so one struct keeps it to a single cache-line touch per token.
struct RowStat {
  double row_sum;
  int64_t occurrence;
};

struct StreamState {
  int ncols = 0;
  ColumnSpec cols[64];
  bool reflexive_single = false;
  int trim_n = 16;
  int num_workers = 1;
  std::string dir;          // spill + output directory
  size_t run_pairs = 0;     // pending-buffer flush threshold (entries)

  // entity registry (stays in RAM; proportional to n_entities)
  GrowTable table;
  std::vector<uint64_t> hashes;
  std::vector<uint8_t> column_ids;
  std::vector<uint32_t> id_len;
  std::vector<int64_t> id_off;   // into the id arena
  std::string id_arena;          // concatenated id bytes (first-seen order)
  std::vector<RowStat> stats;

  // sharded-build controls: emit=false runs an index-only scan (registry +
  // row stats, no pair emission) — the cheap first pass of a per-host
  // row-sharded build; [filt_lo, filt_hi) keeps only pairs whose OUTPUT row
  // falls in the host's row block (filtered at spill time, so the expensive
  // sort/merge only ever sees 1/P of the stream)
  bool emit = true;
  int64_t filt_lo = 0;
  int64_t filt_hi = INT64_MAX;
  // true when the pending buffer may hold out-of-range pairs (only the
  // trim path appends unfiltered); flush_run compacts only then
  bool pend_unfiltered = false;

  // pending pair buffer: raw (no zero-init, unchecked writes); slack above
  // run_pairs absorbs one edge's worst-case emission between flush checks
  std::unique_ptr<KV[]> pending;
  size_t pend_n = 0;
  size_t pend_cap = 0;
  int n_runs = 0;
  int64_t n_pairs_emitted = 0;
  int64_t n_edges_out = -1;  // set by finish
  int64_t skipped = 0;
  std::string error;
  bool finished = false;

  // reused scratch (one chunk at a time)
  std::vector<int64_t> tok_index;
  std::vector<int64_t> hi_a, lo_a, hi_b, lo_b, order;
  std::vector<KV> scratch_kv;
};

static std::string run_path(StreamState* st, int i) {
  return st->dir + "/run_" + std::to_string(i) + ".bin";
}

struct StreamLap {
  bool on;
  double t0;
  static double now() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }
  StreamLap() : on(std::getenv("CLEORA_NATIVE_DEBUG") != nullptr), t0(now()) {}
  void operator()(const char* what) {
    if (on) {
      std::fprintf(stderr, "[stream] %-14s %.3fs\n", what, now() - t0);
      t0 = now();
    }
  }
};

// Append one pair with a capacity check — the fallback for edges whose
// emission exceeds the pending buffer's remaining room (huge trim_n or a
// single enormous hyperedge).  Flushes mid-edge when the buffer fills.
static bool push_pair_checked(StreamState* st, uint64_t key, double val);

static bool flush_run(StreamState* st) {
  if (st->pend_n == 0) return true;
  StreamLap lap;
  KV* p = st->pending.get();
  size_t n = st->pend_n;
  if ((st->filt_lo > 0 || st->filt_hi <= (int64_t)UINT32_MAX) &&
      st->pend_unfiltered) {
    // row-sharded build: drop pairs outside this host's row block before
    // the sort — compaction is one linear pass, the sort then costs 1/P.
    // Skipped when every pair in the buffer came from the fast path,
    // which already filters at emission time (pend_unfiltered tracks it).
    uint64_t lo = (uint64_t)st->filt_lo, hi = (uint64_t)st->filt_hi;
    size_t m = 0;
    for (size_t i = 0; i < n; ++i) {
      uint64_t r = p[i].key >> 32;
      if (r >= lo && r < hi) p[m++] = p[i];
    }
    n = m;
    st->pend_n = m;
    if (n == 0) {
      st->pend_unfiltered = false;
      return true;
    }
  }
  st->n_pairs_emitted += (int64_t)n;
  sort_kv_by_key(p, n, st->num_workers);
  lap("  run:sort");
  std::string path = run_path(st, st->n_runs);
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) {
    st->error = "cannot open spill file " + path;
    return false;
  }
  std::vector<RunEntry> out;
  out.reserve(1 << 16);
  bool wok = true;
  for (size_t i = 0; i < n;) {
    uint64_t k = p[i].key;
    double s = 0.0;
    while (i < n && p[i].key == k) s += p[i++].val;
    out.push_back({k, s});
    if (out.size() == (1 << 16)) {
      wok &= std::fwrite(out.data(), sizeof(RunEntry), out.size(), f) ==
             out.size();
      out.clear();
    }
  }
  if (!out.empty())
    wok &= std::fwrite(out.data(), sizeof(RunEntry), out.size(), f) ==
           out.size();
  wok &= std::fclose(f) == 0;
  if (!wok) {
    st->error = "short write to spill file " + path + " (disk full?)";
    return false;
  }
  lap("  run:dedup+io");
  ++st->n_runs;
  st->pend_n = 0;
  st->pend_unfiltered = false;
  return true;
}

static bool push_pair_checked(StreamState* st, uint64_t key, double val) {
  if (st->pend_n == st->pend_cap && !flush_run(st)) return false;
  st->pending.get()[st->pend_n++] = {key, val};
  return true;
}

// Per-edge row stats: every node on side A gains occurrence += |B| and
// row_sum += 1/|B| (and symmetrically) — the reference's
// src/sparse_matrix_builder.rs:179-185 numerics.  One definition shared by
// the fast, trim and index-only paths.
static inline void edge_stats(RowStat* stats,
                              const std::vector<int64_t>& tok_index,
                              const Edge& e) {
  if (e.a_len == 0 || e.b_len == 0) return;
  double inv_b = (double)(1.0f / (float)e.b_len);
  double inv_a = (double)(1.0f / (float)e.a_len);
  for (int64_t i = 0; i < e.a_len; ++i) {
    RowStat& rs = stats[tok_index[(size_t)(e.a_off + i)]];
    rs.occurrence += e.b_len;
    rs.row_sum += inv_b;
  }
  for (int64_t i = 0; i < e.b_len; ++i) {
    RowStat& rs = stats[tok_index[(size_t)(e.b_off + i)]];
    rs.occurrence += e.a_len;
    rs.row_sum += inv_a;
  }
}

// Sequential per-chunk pipeline step: incremental first-seen indexing, row
// stats, running-occurrence trimming, pair emission into st->pending with
// cap-triggered spills.  `tokens`/`edges` are the stitched chunk output.
static bool stream_consume(StreamState* st, const std::vector<Token>& tokens,
                           const std::vector<Edge>& edges) {
  StreamLap lap;
  int64_t n_tok = (int64_t)tokens.size();
  st->tok_index.resize((size_t)n_tok);
  for (int64_t i = 0; i < n_tok; ++i) {
    const Token& t = tokens[(size_t)i];
    auto [idx, fresh] = st->table.insert(t.hash, (int64_t)st->hashes.size());
    if (fresh) {
      st->hashes.push_back(t.hash);
      st->column_ids.push_back(t.col_id);
      st->id_off.push_back((int64_t)st->id_arena.size());
      st->id_len.push_back(t.len);
      st->id_arena.append(t.ptr, t.len);
      st->stats.push_back({0.0, 0});
    }
    st->tok_index[(size_t)i] = idx;
  }
  lap("index");
  if ((int64_t)st->hashes.size() > (int64_t)INT32_MAX) {
    st->error = "entity count exceeds int32 CSR index range";
    return false;
  }

  auto& tok_index = st->tok_index;
  RowStat* stats = st->stats.data();
  int trim_n = st->trim_n;
  KV* pend = st->pending.get();

  // Index-only scan (pass 1 of a row-sharded build): registry + row stats
  // only.  Trimming state is just the running occurrence counts, which the
  // stats loop maintains, so a later emitting pass over the same input
  // reproduces identical trimming decisions.
  if (!st->emit) {
    for (const Edge& e : edges) edge_stats(stats, tok_index, e);
    lap("stats");
    return true;
  }

  // Fast path: when no hyperedge in this chunk exceeds trim_n, emission
  // order does not matter (pairs get sorted; stat += commutes) — split the
  // edge range across threads with prefix-summed output offsets, flushing
  // between slabs whenever the pending buffer would overflow (mirrors the
  // in-RAM builder's no-trim fast path).  Occurrence still accumulates so a
  // later trimming chunk sees correct running counts.
  bool has_big = false;
  for (const Edge& e : edges)
    if (e.a_len > trim_n || e.b_len > trim_n) {
      has_big = true;
      break;
    }
  if (!has_big) {
    int64_t n_edges = (int64_t)edges.size();
    int W = st->num_workers;
    // row filter (sharded build): skip writing out-of-range pairs at
    // emission time — the scan/stats stay global, but pair writes, sort and
    // spill all shrink to this host's share (the trim path is rare and
    // keeps filtering at flush time instead)
    const bool filt =
        st->filt_lo > 0 || st->filt_hi <= (int64_t)UINT32_MAX;
    const int64_t flo = st->filt_lo, fhi = st->filt_hi;
    auto in_range = [&](int64_t idx) { return idx >= flo && idx < fhi; };
    int64_t i = 0;
    while (i < n_edges) {
      // how many edges fit in the pending buffer from here?
      size_t room = st->pend_cap - st->pend_n;
      int64_t j = i;
      size_t need = 0;
      std::vector<int64_t> offs;
      offs.reserve((size_t)(n_edges - i) + 1);
      offs.push_back(0);
      while (j < n_edges) {
        const Edge& e = edges[(size_t)j];
        size_t emit_n;
        if (!filt) {
          emit_n = (size_t)(e.a_len * e.b_len) * 2;
        } else {
          int64_t a_in = 0, b_in = 0;
          for (int64_t x = 0; x < e.a_len; ++x)
            a_in += in_range(tok_index[(size_t)(e.a_off + x)]);
          for (int64_t y = 0; y < e.b_len; ++y)
            b_in += in_range(tok_index[(size_t)(e.b_off + y)]);
          emit_n = (size_t)(a_in * e.b_len + b_in * e.a_len);
        }
        if (need + emit_n > room) break;
        need += emit_n;
        offs.push_back((int64_t)need);
        ++j;
      }
      if (j == i) {  // buffer full before one edge fits
        if (st->pend_n > 0) {
          if (!flush_run(st)) return false;
          continue;
        }
        // a single edge larger than the whole buffer: emit it pair by
        // pair with capacity checks (flushing mid-edge), then move on —
        // retrying through the slab planner would spin forever
        const Edge& e = edges[(size_t)i];
        if (e.a_len > 0 && e.b_len > 0) {
          double val = (double)(float)(1.0 / (double)(e.a_len * e.b_len));
          for (int64_t x = 0; x < e.a_len; ++x) {
            int64_t a = tok_index[(size_t)(e.a_off + x)];
            bool a_in = !filt || in_range(a);
            for (int64_t y = 0; y < e.b_len; ++y) {
              int64_t b = tok_index[(size_t)(e.b_off + y)];
              if (a_in && !push_pair_checked(st, pack(a, b), val))
                return false;
              if ((!filt || in_range(b)) &&
                  !push_pair_checked(st, pack(b, a), val))
                return false;
            }
          }
          edge_stats(stats, tok_index, e);  // the slab loop skips this edge
        }
        ++i;
        continue;
      }
      KV* base = pend + st->pend_n;
      int64_t slab = j - i;
      int Wt = (int)std::min<int64_t>(W, slab);
      std::vector<std::thread> threads;
      int64_t per = (slab + Wt - 1) / Wt;
      for (int w = 0; w < Wt; ++w) {
        threads.emplace_back([&, w] {
          int64_t lo = std::min(slab, w * per);
          int64_t hi = std::min(slab, lo + per);
          for (int64_t k = lo; k < hi; ++k) {
            const Edge& e = edges[(size_t)(i + k)];
            if (e.a_len == 0 || e.b_len == 0) continue;
            double val = (double)(float)(1.0 / (double)(e.a_len * e.b_len));
            KV* out = base + offs[(size_t)k];
            if (!filt) {
              for (int64_t x = 0; x < e.a_len; ++x) {
                int64_t a = tok_index[(size_t)(e.a_off + x)];
                for (int64_t y = 0; y < e.b_len; ++y) {
                  int64_t b = tok_index[(size_t)(e.b_off + y)];
                  *out++ = {pack(a, b), val};
                  *out++ = {pack(b, a), val};
                }
              }
            } else {
              // same pair multiset restricted to rows in [flo, fhi)
              for (int64_t x = 0; x < e.a_len; ++x) {
                int64_t a = tok_index[(size_t)(e.a_off + x)];
                bool a_in = in_range(a);
                for (int64_t y = 0; y < e.b_len; ++y) {
                  int64_t b = tok_index[(size_t)(e.b_off + y)];
                  if (a_in) *out++ = {pack(a, b), val};
                  if (in_range(b)) *out++ = {pack(b, a), val};
                }
              }
            }
          }
        });
      }
      // stats sequentially on the main thread, overlapping the pair writes
      for (int64_t k = i; k < j; ++k)
        edge_stats(stats, tok_index, edges[(size_t)k]);
      for (auto& t : threads) t.join();
      st->pend_n += need;
      i = j;
      if (st->pend_n >= st->run_pairs) {
        lap("emit");
        if (!flush_run(st)) return false;
        lap("spill");
      }
    }
    lap("emit");
    return true;
  }

  // general (trim) path: pairs are appended WITHOUT the row filter; mark
  // the buffer so flush_run compacts it (the fast path above filters at
  // emission and leaves the flag unset)
  if (st->filt_lo > 0 || st->filt_hi <= (int64_t)UINT32_MAX)
    st->pend_unfiltered = true;

  for (const Edge& e : edges) {
    if (e.a_len == 0 || e.b_len == 0) continue;
    edge_stats(stats, tok_index, e);
    double val = (double)(float)(1.0 / (double)(e.a_len * e.b_len));

    auto trim_side = [&](int64_t off, int64_t len, std::vector<int64_t>& hi,
                         std::vector<int64_t>& lo) {
      hi.clear();
      lo.clear();
      if (len <= trim_n) {
        for (int64_t i = 0; i < len; ++i)
          hi.push_back(tok_index[(size_t)(off + i)]);
        return;
      }
      auto& order = st->order;
      order.resize((size_t)len);
      for (int64_t i = 0; i < len; ++i) order[(size_t)i] = i;
      std::stable_sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
        return stats[tok_index[(size_t)(off + x)]].occurrence >
               stats[tok_index[(size_t)(off + y)]].occurrence;
      });
      for (int64_t i = 0; i < len; ++i) {
        int64_t n = tok_index[(size_t)(off + order[(size_t)i])];
        (i < trim_n ? hi : lo).push_back(n);
      }
    };

    size_t emit_small = (size_t)(e.a_len * e.b_len) * 2;
    if (e.a_len <= trim_n && e.b_len <= trim_n &&
        emit_small <= st->pend_cap - st->pend_n) {
      KV* out = pend + st->pend_n;
      for (int64_t i = 0; i < e.a_len; ++i) {
        int64_t a = tok_index[(size_t)(e.a_off + i)];
        for (int64_t j = 0; j < e.b_len; ++j) {
          int64_t b = tok_index[(size_t)(e.b_off + j)];
          *out++ = {pack(a, b), val};
          *out++ = {pack(b, a), val};
        }
      }
      st->pend_n = (size_t)(out - pend);
    } else if (e.a_len <= trim_n && e.b_len <= trim_n) {
      // untrimmed edge too large for the buffer remainder (huge trim_n):
      // checked per-pair emission, flushing mid-edge
      for (int64_t i = 0; i < e.a_len; ++i) {
        int64_t a = tok_index[(size_t)(e.a_off + i)];
        for (int64_t j = 0; j < e.b_len; ++j) {
          int64_t b = tok_index[(size_t)(e.b_off + j)];
          if (!push_pair_checked(st, pack(a, b), val)) return false;
          if (!push_pair_checked(st, pack(b, a), val)) return false;
        }
      }
    } else {
      // rare path: emit via a scratch vector, then copy into the buffer
      auto& scratch = st->scratch_kv;
      scratch.clear();
      trim_side(e.a_off, e.a_len, st->hi_a, st->lo_a);
      trim_side(e.b_off, e.b_len, st->hi_b, st->lo_b);
      emit_cartesian(st->hi_a.data(), (int64_t)st->hi_a.size(),
                     st->hi_b.data(), (int64_t)st->hi_b.size(), val, scratch);
      emit_cartesian(st->hi_a.data(), (int64_t)st->hi_a.size(),
                     st->lo_b.data(), (int64_t)st->lo_b.size(), val, scratch);
      emit_cartesian(st->lo_a.data(), (int64_t)st->lo_a.size(),
                     st->hi_b.data(), (int64_t)st->hi_b.size(), val, scratch);
      for (size_t i = 0; i < scratch.size();) {
        size_t room = st->pend_cap - st->pend_n;
        size_t take = std::min(room, scratch.size() - i);
        std::memcpy(pend + st->pend_n, scratch.data() + i, take * sizeof(KV));
        st->pend_n += take;
        i += take;
        if (st->pend_n >= st->run_pairs) {
            if (!flush_run(st)) return false;
        }
      }
    }
    if (st->pend_n >= st->run_pairs) {
      lap("emit");
          if (!flush_run(st)) return false;
      lap("spill");
    }
  }
  lap("emit");
  return true;
}

// K-way merge of sorted runs with buffered readers.
struct RunReader {
  FILE* f = nullptr;
  std::vector<RunEntry> buf;
  size_t pos = 0, have = 0;
  bool done = false;

  // close on destruction so every early-error return path in
  // stream_finish releases the K spill-file handles
  ~RunReader() {
    if (f) std::fclose(f);
  }

  bool refill() {
    have = std::fread(buf.data(), sizeof(RunEntry), buf.size(), f);
    pos = 0;
    if (have == 0) {
      done = true;
      return false;
    }
    return true;
  }
  bool next(RunEntry& e) {
    if (pos == have && (done || !refill())) return false;
    e = buf[pos++];
    return true;
  }
};

struct BufWriter {
  FILE* f = nullptr;
  std::vector<char> buf;
  size_t pos = 0;

  bool open(const std::string& p) {
    f = std::fopen(p.c_str(), "wb");
    buf.resize(4 << 20);
    pos = 0;
    return f != nullptr;
  }
  bool ok = true;  // sticky: any short write (disk full) marks the writer
  inline void put(const void* p, size_t n) {
    if (pos + n > buf.size()) {
      ok &= std::fwrite(buf.data(), 1, pos, f) == pos;
      pos = 0;
    }
    std::memcpy(buf.data() + pos, p, n);
    pos += n;
  }
  void close() {
    if (f) {
      ok &= std::fwrite(buf.data(), 1, pos, f) == pos;
      ok &= std::fclose(f) == 0;
      f = nullptr;
    }
  }
  ~BufWriter() {  // error-path cleanup; success paths call close()
    if (f) std::fclose(f);
  }
};

static bool stream_finish(StreamState* st) {
  if (st->hashes.empty()) {
    st->error = "No valid hyperedge lines provided";
    return false;
  }
  if (!flush_run(st)) return false;

  int64_t n_ent = (int64_t)st->hashes.size();
  int K = st->n_runs;
  std::vector<RunReader> readers((size_t)K);
  std::vector<RunEntry> heads((size_t)K);
  size_t per_run_buf = std::max<size_t>(1 << 12, (64 << 20) / std::max(K, 1) /
                                                     sizeof(RunEntry));
  for (int k = 0; k < K; ++k) {
    readers[(size_t)k].f = std::fopen(run_path(st, k).c_str(), "rb");
    if (!readers[(size_t)k].f) {
      st->error = "cannot reopen spill file";
      return false;
    }
    readers[(size_t)k].buf.resize(per_run_buf);
  }
  // Loser tree over the K run heads: next winner in O(log K) comparisons
  // with no per-entry heap churn.  Exhausted runs hold key UINT64_MAX
  // (padding keys are < 2^62, so the sentinel never collides).
  constexpr uint64_t DONE_KEY = ~0ULL;
  int P = 1;
  while (P < std::max(K, 1)) P <<= 1;
  std::vector<uint64_t> head_key((size_t)P, DONE_KEY);
  for (int k = 0; k < K; ++k)
    head_key[(size_t)k] =
        readers[(size_t)k].next(heads[(size_t)k]) ? heads[(size_t)k].key
                                                  : DONE_KEY;
  // tree[1] is the overall winner; tree[i] holds the loser of the match at
  // internal node i.  Rebuild cost O(P) once; per-advance O(log P).
  std::vector<int> tree((size_t)(2 * P), -1);
  auto replay = [&](int leaf) {
    int winner = leaf;
    for (int node = (P + leaf) >> 1; node >= 1; node >>= 1) {
      int& held = tree[(size_t)node];
      if (held >= 0 &&
          (head_key[(size_t)held] < head_key[(size_t)winner] ||
           (head_key[(size_t)held] == head_key[(size_t)winner] &&
            held < winner)))
        std::swap(held, winner);
    }
    return winner;
  };
  int winner = -1;
  {
    // initialize: insert leaves one by one
    for (int leaf = 0; leaf < P; ++leaf) {
      int w = leaf;
      for (int node = (P + leaf) >> 1; node >= 1; node >>= 1) {
        int& held = tree[(size_t)node];
        if (held < 0) {
          held = w;
          w = -1;
          break;
        }
        if (head_key[(size_t)held] < head_key[(size_t)w] ||
            (head_key[(size_t)held] == head_key[(size_t)w] && held < w))
          std::swap(held, w);
      }
      if (w >= 0) winner = w;
    }
  }

  BufWriter w_idx, w_left, w_sym;
  if (!w_idx.open(st->dir + "/indices.bin") ||
      !w_left.open(st->dir + "/left_vals.bin") ||
      !w_sym.open(st->dir + "/sym_vals.bin")) {
    st->error = "cannot open output file in " + st->dir;
    return false;
  }
  std::vector<int64_t> indptr((size_t)n_ent + 1, 0);
  // compact per-row sums: 8 B random accesses during the merge instead of
  // 16 B RowStat lines (the merge is cache-miss-bound on rs[c]); division
  // and sqrt-of-product match the in-RAM builder's emit arithmetic
  // (builder.cpp phase 5) rather than a reciprocal approximation
  std::vector<double> rs((size_t)n_ent);
  for (int64_t i = 0; i < n_ent; ++i)
    rs[(size_t)i] = st->stats[(size_t)i].row_sum;
  int64_t n_out = 0;

  uint64_t cur_key = 0;
  double cur_sum = 0.0;
  bool any = false;
  auto emit = [&]() {
    size_t r = (size_t)(cur_key >> 32);
    size_t c = (size_t)(uint32_t)cur_key;
    int32_t ci = (int32_t)c;
    float lv = (float)(cur_sum / rs[r]);
    float sv = (float)(cur_sum / std::sqrt(rs[r] * rs[c]));
    w_idx.put(&ci, 4);
    w_left.put(&lv, 4);
    w_sym.put(&sv, 4);
    ++indptr[r + 1];
    ++n_out;
  };
  if (K == 1) {
    // single run: keys are already unique (per-run dedup) — stream it
    // (the tree init pre-read the first entry into heads[0])
    if (head_key[0] != DONE_KEY) {
      cur_key = heads[0].key;
      cur_sum = heads[0].val;
      emit();
      RunEntry e;
      while (readers[0].next(e)) {
        cur_key = e.key;
        cur_sum = e.val;
        emit();
      }
    }
    any = false;
  } else {
    while (winner >= 0 && head_key[(size_t)winner] != DONE_KEY) {
      int k = winner;
      RunEntry e = heads[(size_t)k];
      if (any && e.key != cur_key) {
        emit();
        cur_sum = 0.0;
      }
      cur_key = e.key;
      cur_sum += e.val;
      any = true;
      head_key[(size_t)k] = readers[(size_t)k].next(heads[(size_t)k])
                                ? heads[(size_t)k].key
                                : DONE_KEY;
      winner = replay(k);
    }
  }
  if (any) emit();
  w_idx.close();
  w_left.close();
  w_sym.close();
  if (!w_idx.ok || !w_left.ok || !w_sym.ok) {
    st->error = "short write to output CSR in " + st->dir + " (disk full?)";
    return false;
  }
  for (auto& r : readers) {
    if (r.f) std::fclose(r.f);
    r.f = nullptr;  // the destructor must not close again
  }
  for (int k = 0; k < K; ++k) std::remove(run_path(st, k).c_str());

  for (int64_t i = 0; i < n_ent; ++i) indptr[(size_t)i + 1] += indptr[(size_t)i];

  // entity-table + indptr outputs
  auto dump = [&](const char* name, const void* p, size_t bytes) {
    FILE* f = std::fopen((st->dir + "/" + name).c_str(), "wb");
    if (!f) return false;
    bool k = bytes == 0 || std::fwrite(p, 1, bytes, f) == bytes;
    return (std::fclose(f) == 0) && k;
  };
  std::vector<float> rs32((size_t)n_ent);
  for (int64_t i = 0; i < n_ent; ++i)
    rs32[(size_t)i] = (float)st->stats[(size_t)i].row_sum;
  bool ok = dump("indptr.bin", indptr.data(), indptr.size() * 8) &&
            dump("hashes.bin", st->hashes.data(), st->hashes.size() * 8) &&
            dump("column_ids.bin", st->column_ids.data(),
                 st->column_ids.size()) &&
            dump("row_sums.bin", rs32.data(), rs32.size() * 4) &&
            dump("id_lens.bin", st->id_len.data(), st->id_len.size() * 4) &&
            dump("id_blob.bin", st->id_arena.data(), st->id_arena.size());
  if (!ok) {
    st->error = "cannot write output arrays in " + st->dir;
    return false;
  }
  st->n_edges_out = n_out;
  st->finished = true;
  st->pending.reset();  // release the pair buffer
  st->pend_cap = st->pend_n = 0;
  return true;
}

}  // namespace

extern "C" {

void* ct_stream_open(int ncols, const uint8_t* complex_flags,
                     const uint8_t* reflexive_flags, int trim_n,
                     int num_workers, const char* spill_dir,
                     int64_t ram_cap_bytes) try {
  auto* st = new StreamState();
  st->ncols = ncols;
  for (int i = 0; i < ncols && i < 64; ++i)
    st->cols[i] = {complex_flags[i], reflexive_flags[i]};
  st->reflexive_single = (ncols == 1);
  st->trim_n = trim_n;
  st->num_workers =
      num_workers > 0 ? num_workers
                      : (int)std::max(1u, std::thread::hardware_concurrency());
  st->dir = spill_dir;
  // pending KV entries are 16 B; leave half the cap for sort scratch + chunk
  int64_t cap = std::max<int64_t>(ram_cap_bytes, 64 << 20);
  st->run_pairs = (size_t)(cap / 2 / (int64_t)sizeof(KV));
  if (const char* ov = std::getenv("CLEORA_STREAM_RUN_PAIRS"))
    st->run_pairs = (size_t)std::max(1024LL, std::atoll(ov));  // tests only
  // slack: the untrimmed fast path writes one edge (<= trim capped sides of
  // 64 each in practice, but a no-trim build can have wider lines; 1M slots
  // of slack covers sides up to ~700x700) between flush checks
  st->pend_cap = st->run_pairs + (1u << 20);
  st->pending.reset(new (std::nothrow) KV[st->pend_cap]);
  if (!st->pending) {
    delete st;
    return nullptr;  // impossible ram_cap: caller raises a clean error
  }
  return st;
} catch (...) {
  // bad_alloc (or any other exception) must not unwind through the
  // ctypes frame — that would std::terminate the Python process
  return nullptr;
}

// Sharded-build controls (set before the first feed).  emit=0 runs the
// index-only pass: registry + row stats, no pairs.  The row filter keeps
// only pairs whose output row index lands in [lo, hi) — the per-host row
// block of a multi-host build (pass 2).
void ct_stream_set_emit(void* h, int emit) {
  ((StreamState*)h)->emit = emit != 0;
}

void ct_stream_set_row_filter(void* h, int64_t lo, int64_t hi) {
  auto* st = (StreamState*)h;
  st->filt_lo = lo < 0 ? 0 : lo;
  st->filt_hi = hi;
}

// Feed one newline-terminated text chunk (must not split a line across
// feeds).  is_file_mode=1 applies the file-path semantics: skip empty and
// invalid-UTF-8 lines.  Returns 0 on success.
// Converts any escaping exception (bad_alloc from the token/edge vectors
// and arenas, primarily) into the handle's error string — an exception
// crossing the extern "C" ctypes frame would std::terminate Python.
static int guard_fail(StreamState* st) {
  try {
    if (st->error.empty()) st->error = "out of memory in streaming build";
  } catch (...) {
  }
  return 1;
}

int ct_stream_feed(void* h, const char* buf, int64_t len, int is_file_mode)
try {
  auto* st = (StreamState*)h;
  if (!st->error.empty() || st->finished) return 1;

  std::vector<std::pair<const char*, const char*>> lines;
  split(buf, buf + len, '\n', [&](const char* s, const char* t) {
    if (!is_file_mode || t > s) lines.emplace_back(s, t);
  });
  // feed boundaries are line boundaries, so a trailing "" from a final
  // newline is dropped even in iterator mode (it was not a real line)
  if (!is_file_mode && !lines.empty() && len > 0 && buf[len - 1] == '\n')
    lines.pop_back();
  int64_t n_lines = (int64_t)lines.size();
  if (n_lines == 0) return 0;

  int W = (int)std::min<int64_t>(st->num_workers, n_lines);
  std::vector<WorkerOut> outs((size_t)W);
  {
    std::vector<std::thread> threads;
    int64_t chunk = (n_lines + W - 1) / W;
    for (int w = 0; w < W; ++w) {
      threads.emplace_back([&, w] {
        int64_t lo = std::min(n_lines, w * chunk);
        int64_t hi = std::min(n_lines, lo + chunk);
        auto& out = outs[(size_t)w];
        for (int64_t i = lo; i < hi; ++i) {
          if (is_file_mode &&
              !utf8_valid(lines[(size_t)i].first, lines[(size_t)i].second)) {
            ++out.skipped;
            continue;
          }
          if (!parse_line(lines[(size_t)i].first, lines[(size_t)i].second,
                          st->ncols, st->cols, st->reflexive_single, out))
            ++out.skipped;
        }
      });
    }
    for (auto& t : threads) t.join();
  }
  std::vector<Token> tokens;
  std::vector<Edge> edges;
  {
    size_t tt = 0, te = 0;
    for (auto& o : outs) {
      tt += o.tokens.size();
      te += o.edges.size();
      st->skipped += o.skipped;
    }
    tokens.reserve(tt);
    edges.reserve(te);
    for (auto& o : outs) {
      int64_t base = (int64_t)tokens.size();
      tokens.insert(tokens.end(), o.tokens.begin(), o.tokens.end());
      for (auto e : o.edges) {
        e.a_off += base;
        e.b_off += base;
        edges.push_back(e);
      }
    }
  }
  return stream_consume(st, tokens, edges) ? 0 : 1;
} catch (...) {
  return guard_fail((StreamState*)h);
}

// Feed raw integer pairs (the synthetic-scale and from_edge_arrays path).
// Ids are formatted as decimal strings internally, so hashing, the entity
// table and the output are bitwise-identical to feeding "src dst" text.
int ct_stream_feed_pairs(void* h, const int64_t* src, const int64_t* dst,
                         int64_t n) try {
  auto* st = (StreamState*)h;
  StreamLap lap;
  if (!st->error.empty() || st->finished) return 1;
  // single complex::reflexive column (clique incl. self-loops), or two
  // columns (directed pair per line, tokens tagged with their column)
  bool two_col = (st->ncols == 2);
  if (!two_col && !(st->ncols == 1 && st->reflexive_single)) {
    st->error =
        "pair feed requires complex::reflexive single-column or two columns";
    return 1;
  }
  int W = (int)std::min<int64_t>(st->num_workers, std::max<int64_t>(1, n));
  std::vector<WorkerOut> outs((size_t)W);
  std::vector<std::string> arenas((size_t)W);
  {
    std::vector<std::thread> threads;
    int64_t chunk = (n + W - 1) / W;
    for (int w = 0; w < W; ++w) {
      threads.emplace_back([&, w] {
        int64_t lo = std::min(n, w * chunk);
        int64_t hi = std::min(n, lo + chunk);
        auto& out = outs[(size_t)w];
        auto& arena = arenas[(size_t)w];
        out.tokens.reserve((size_t)(hi - lo) * 2);
        out.edges.reserve((size_t)(hi - lo));
        arena.reserve((size_t)(hi - lo) * 14);
        char tmp[24];
        auto put = [&](int64_t v) {
          int m = std::snprintf(tmp, sizeof tmp, "%lld", (long long)v);
          size_t off = arena.size();
          arena.append(tmp, (size_t)m);
          // ptr fixed up after the arena stops growing (below)
          out.tokens.push_back({0, (const char*)off, (uint32_t)m, 0});
        };
        for (int64_t i = lo; i < hi; ++i) {
          int64_t off = (int64_t)out.tokens.size();
          put(src[i]);
          put(dst[i]);
          if (two_col)
            out.edges.push_back({off, 1, off + 1, 1});
          else
            out.edges.push_back({off, 2, off, 2});
        }
        // resolve offsets → stable pointers, then hash; 2-col mode tags
        // alternating tokens with their column id
        size_t ti = 0;
        for (auto& t : out.tokens) {
          t.ptr = arena.data() + (size_t)(uintptr_t)t.ptr;
          t.hash = xxh64(t.ptr, t.len);
          if (two_col) t.col_id = (uint8_t)(ti & 1);
          ++ti;
        }
      });
    }
    for (auto& t : threads) t.join();
  }
  lap("itoa+hash");
  std::vector<Token> tokens;
  std::vector<Edge> edges;
  size_t tt = 0, te = 0;
  for (auto& o : outs) {
    tt += o.tokens.size();
    te += o.edges.size();
  }
  tokens.reserve(tt);
  edges.reserve(te);
  for (auto& o : outs) {
    int64_t base = (int64_t)tokens.size();
    tokens.insert(tokens.end(), o.tokens.begin(), o.tokens.end());
    for (auto e : o.edges) {
      e.a_off += base;
      e.b_off += base;
      edges.push_back(e);
    }
  }
  lap("stitch");
  return stream_consume(st, tokens, edges) ? 0 : 1;
} catch (...) {
  return guard_fail((StreamState*)h);
}

int ct_stream_finish(void* h) try {
  auto* st = (StreamState*)h;
  if (!st->error.empty()) return 1;
  return stream_finish(st) ? 0 : 1;
} catch (...) {
  return guard_fail((StreamState*)h);
}

const char* ct_stream_error(void* h) {
  auto* st = (StreamState*)h;
  return st->error.empty() ? nullptr : st->error.c_str();
}

int64_t ct_stream_num_entities(void* h) {
  return (int64_t)((StreamState*)h)->hashes.size();
}

int64_t ct_stream_num_edges(void* h) {
  return ((StreamState*)h)->n_edges_out;
}

int64_t ct_stream_skipped(void* h) { return ((StreamState*)h)->skipped; }

int64_t ct_stream_pairs_emitted(void* h) {
  return ((StreamState*)h)->n_pairs_emitted;
}

int ct_stream_num_runs(void* h) { return ((StreamState*)h)->n_runs; }

void ct_stream_free(void* h) { delete (StreamState*)h; }

}  // extern "C"
