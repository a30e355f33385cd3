// Packed-result decode loops: the host half of the single result fetch
// (the port's ops/decode.py binding; a copy of nomad_tpu/native/decode.cc).
//
// After the fetch, the host turns the COO placement payload into (a)
// per-alloc node-index runs per spec (the plan materialization feed) and
// (b) per-spec last-commit score entries (the AllocMetric feed).  Both
// are integer passes over nnz entries: at config_mesh width a million
// entries of numpy fancy-indexing and a Python loop.  These are their
// straight-line C twins, bound with ctypes like wal.cc and codec.cc; the
// numpy twins in ops/decode.py are the reference the guard compares with.
//
// Contract (shared with the numpy twins, pinned by the guard):
//  - entries are grouped by ascending spec row (the COO emit order);
//  - an entry is live iff rows[i] >= 0 && cols[i] < n_real, as the numpy
//    mask (validation has rejected negative cols on live rows before
//    decode runs);
//  - ndec_expand appends counts[i] copies of cols[i] per live entry;
//  - ndec_last_scores keeps, per (spec, col), the LAST entry's
//    score/collisions at the FIRST occurrence's position (the dict
//    insertion order of the twin).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC at first use, into the
// repository's build/native/ (nomad_tpu_torch/native/__init__.py).

#include <cstdint>

extern "C" {

// Expand live COO entries into per-alloc node indexes.
//   off:     [n_specs + 1] int64, exclusive prefix per spec (output)
//   out_idx: [cap] int32 expanded node indexes (output)
// Returns total entries written, or -1 when cap would overflow.
long long ndec_expand(const int32_t* rows, const int32_t* cols,
                      const int32_t* counts, long long n,
                      int32_t n_specs, int32_t n_real,
                      long long* off, int32_t* out_idx, long long cap) {
  for (int32_t u = 0; u <= n_specs; u++) off[u] = 0;
  long long total = 0;
  for (long long i = 0; i < n; i++) {
    int32_t u = rows[i];
    int32_t c = cols[i];
    if (u < 0 || c >= n_real) continue;
    long long k = counts[i];
    if (k <= 0) continue;
    if (total + k > cap || u >= n_specs) return -1;
    for (long long j = 0; j < k; j++) out_idx[total + j] = c;
    off[u + 1] += k;
    total += k;
  }
  for (int32_t u = 0; u < n_specs; u++) off[u + 1] += off[u];
  return total;
}

// Per-spec last-commit score dedup (slot-mode COO carries one entry per
// alloc, so a node committed in several rounds appears several times;
// the AllocMetric keeps the LAST commit's score).
//   stamp: [n_real] int32 scratch, caller-filled with -1
//   pos:   [n_real] int64 scratch (uninitialized ok)
//   out_off: [n_specs + 1] int64 exclusive prefix per spec (output)
//   out_col/out_score/out_coll: [n] outputs (worst case: no dups)
// Returns total deduped entries, or -1 on a non-ascending spec run.
long long ndec_last_scores(const int32_t* rows, const int32_t* cols,
                           const float* scores, const int32_t* coll,
                           long long n, int32_t n_specs, int32_t n_real,
                           int32_t* stamp, long long* pos,
                           long long* out_off, int32_t* out_col,
                           float* out_score, int32_t* out_coll) {
  for (int32_t u = 0; u <= n_specs; u++) out_off[u] = 0;
  long long total = 0;
  int32_t cur_u = -1;
  for (long long i = 0; i < n; i++) {
    int32_t u = rows[i];
    int32_t c = cols[i];
    if (u < 0 || c >= n_real) continue;
    if (u < cur_u || u >= n_specs || c < 0) return -1;
    cur_u = u;
    if (stamp[c] == u) {
      long long p = pos[c];
      out_score[p] = scores[i];
      out_coll[p] = coll[i];
    } else {
      stamp[c] = u;
      pos[c] = total;
      out_col[total] = c;
      out_score[total] = scores[i];
      out_coll[total] = coll[i];
      out_off[u + 1] += 1;
      total++;
    }
  }
  for (int32_t u = 0; u < n_specs; u++) out_off[u + 1] += out_off[u];
  return total;
}

}  // extern "C"
