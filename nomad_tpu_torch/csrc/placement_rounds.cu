// placement_rounds: the batch scheduler's rank-and-commit loop, every
// round of it in one cooperative launch over the whole card, written by
// hand for Hopper (sm_90a).
//
// Replaces the reference's schedule program, the XLA while/scan
// nomad_tpu/ops/kernels.py:_placement_rounds_impl (:412), with its exact
// top-k _select_top_k (:157) and byte histograms (:124-154); there is no
// pallas_call.  A round walks every spec in order, so spec u + 1 sees
// spec u's commit.  For each spec with work left:
//
//   ok   = feas[u,n] && fits(ask[u], cap[n] - used[n])
//          && (!distinct_hosts[u] || coll[n] == 0)          coll = job
//          && net fit (bandwidth, free dynamic ports,         counts row
//             no reserved port taken)                          ji[u]
//          && distinct_property (value present and unused)
//   k    = min(remaining[u], |ok|); nothing happens when k == 0
//   key  = the order-preserving uint32 image of the commit score
//          base - penalty[u]*coll[n] + jitter(seed, u, n)
//   sel  = the k ok nodes of largest key: four byte-histogram passes
//          find the k-th largest key T; the nodes above T, then the == T
//          band in ascending node order
//   dp   = per property value the best key, then the lowest node index
//   commit usage, job counts, net state, dp state, and the slot record
//          (slot mode: dest = placed so far + prefix of sel - 1, dropped
//          at or past M) or the placement and score matrices.
//
// The loop runs inside the launch as the reference's round_cond
// (kernels.py:615-634) runs it: a round starts while asks are left, the
// last round placed something, rounds < max_rounds, and some node fits
// the dimension-wise smallest ask still wanted.  The launch writes its
// status once, at its end: rounds, committing steps, and the grid it ran
// on.  The wrapper reads it once a call.
//
// What bounds it on an H100.  Per committing step the kernel must read
// each node's used, cap (16 B each), denom (8 B), feas (1 B) and job
// count (4 B) once, 45 B a node (more with networks and
// distinct_property), and write the k committed rows: at 1,000,064 nodes
// 45 MB a step, 13.4 us at 3.35 TB/s; at config (b) (10,112 nodes) 0.46
// MB, 0.14 us, where the chain of dependent steps sets the pace.
//
// Design.  A persistent cooperative grid of G blocks, at most one per SM
// (G from N: one tile of kThreads nodes a block at least, so small
// batches pay barriers over few blocks).  Block b owns the contiguous
// nodes [b * chunk, (b + 1) * chunk): only it reads or writes their used,
// job counts, network state, keys and flags, so spec u's commit reaches
// spec u + 1's scoring through __syncthreads alone.  Thread t of a block
// owns its nodes t, t + kThreads, ...  The keys and flags of a block's
// nodes live in its dynamic shared memory (5 B a node: 38 KB at 1M nodes
// over 132 blocks), or, where a block's share does not fit (above
// about 5.9M nodes on 132 SMs), in the global scratch.  What crosses
// blocks, through global tables read with coherent loads (__ldcg) after
// a grid barrier:
//   - each radix pass's 256-bin histogram: every block merges its
//     shared-memory histogram into the pass's global table with one atomic
//     per nonzero bin; the tables rotate over three sets by step, so a
//     set is zeroed two steps before its next use and no barrier is spent
//     on zeroing;
//   - each block's count of keys above T over the first three passes and
//     the suffix sums of its last pass's histogram: after the fourth pass
//     every block reads those of the blocks before it, so the == T band
//     and the slot destinations stay in ascending node order across the
//     grid with no fifth barrier;
//   - distinct_property's best (key, -node) per value, one 64-bit
//     atomicMax (order-free), and each block's count of kept picks;
//   - each block's min-ask fit at the round's end.
// A committing step costs four grid barriers (one a byte pass), two more
// with distinct_property, and a round two more; a step with k == 0 one.
// Every block computes the same k, T, band and loop decisions from the
// same global tables, so all take the same barriers, and no output
// depends on G or on the order of atomics.  Histograms within a block
// are 256 shared-memory bins fed by warp-aggregated atomics
// (__match_any_sync: one atomic per distinct byte in a warp).  The == T
// band's prefix and the slot destinations come from one block scan per
// tile, in node order, with a carry across tiles that starts at the
// blocks before.  The scores are score_common's functions (make_node,
// fits, score_fit, commit_score): the bits of scored_rows, so the kernel
// equals the eager loop bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

// The block's threads: 1,024 on the card (device.py sets nothing);
// tests/test_torch_round_source.py also builds the source with g++ at 64,
// against a CPU mock of the runtime.
#ifndef NOMAD_ROUND_THREADS
#define NOMAD_ROUND_THREADS 1024
#endif

// The block's dynamic shared memory: its nodes' keys, then their flags.
extern __shared__ __align__(16) unsigned char nomad_round_smem[];

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = NOMAD_ROUND_THREADS;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kWarps <= 32, "one warp scans the warps");
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNoBin = 256;        // a lane that adds to no histogram bin
constexpr int kMissing = -1;       // ops/encode.py MISSING
constexpr int kAskNone = 1 << 30;  // the min-ask of a spec with no work left
constexpr int kMaxPortWords = 2048;  // 65,536 ports a bit each (W <= this)
// The grid scratch (int32): three sets of four passes' histograms, then
// per block its count above T, its last pass's suffix sums (257), its
// kept distinct_property picks and its min-ask fit.  ops/fused_score.py
// round_grid_ints sizes it.
constexpr int kHistSet = 4 * 256;

// The kernel's arguments.  Every field is 8 bytes, in the order of
// _ROUND_TENSORS and _ROUND_SIZES in ops/fused_score.py, which builds it
// with ctypes.  A null network or distinct_property pointer means the
// batch has none; placements/commit_* are null in slot mode, slots/slot_*
// in matrix mode, and the score outputs without scores.
struct RoundArgs {
  const uint8_t* feas;        // [U, N]
  int32_t* used;              // [N, 4], committed into
  const int32_t* cap;         // [N, 4]
  const float* denom;         // [N, 2]
  const int32_t* ask;         // [U, 4]
  const int32_t* count;       // [U]
  int32_t* remaining;         // [U]
  const float* penalty;       // [U]
  const uint8_t* dh;          // [U] distinct_hosts
  const int32_t* ji;          // [U] job row of the spec
  int32_t* job_counts;        // [J, N]
  const uint8_t* net_active;  // [U]
  const int32_t* mbits;       // [U]
  const int32_t* dyn_need;    // [U]
  const int32_t* resv_words;  // [U, W]
  const int32_t* bw_cap;      // [N]
  int32_t* bw_used;           // [N]
  int32_t* dyn_free;          // [N]
  int32_t* port_words;        // [N, W]
  const uint8_t* dp_active;   // [U]
  const int32_t* dp_col;      // [U], clipped into [0, K)
  uint8_t* dp_used;           // [U, V]
  const int32_t* attr;        // [N, K]
  int32_t* placements;        // [U, N]
  float* commit_scores;       // [U, N]
  int32_t* commit_coll;       // [U, N]
  int32_t* slots;             // [U, M]
  float* slot_scores;         // [U, M]
  int32_t* slot_coll;         // [U, M]
  uint32_t* key;              // [N] scratch: keys that miss shared memory
  uint8_t* flag;              // [N] scratch: 1 ok, 2 selected, 3 dp pick
  unsigned long long* dp_pick;  // [V] scratch: best (key, ~node) a value
  int32_t* grid;              // the grid scratch, laid out above
  int32_t* status;            // [4]: rounds, steps, blocks, keys shared
  int64_t u, n, w, k_attr, v, slot_m, max_rounds, max_blocks, seed;
};

// How the entry point laid the launch out.
struct Plan {
  int blocks;      // G
  int chunk;       // the nodes a block owns (the last may own fewer)
  int smem_keys;   // 1: keys and flags in dynamic shared memory
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// float order == unsigned order of the image (kernels.py:176-178).
__device__ __forceinline__ uint32_t ordered_key(float s) {
  const uint32_t b = __float_as_uint(s);
  return (b >> 31) == 0 ? (b | 0x80000000u) : ~b;
}

// Loads of rows this launch writes (never __ldg).
__device__ __forceinline__ int4 load4(const int32_t* p, int i) {
  return reinterpret_cast<const int4*>(p)[i];
}

// hist[bin] += 1 for every lane whose bin is not kNoBin: one atomic per
// distinct bin in the warp.  Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(int* hist, int bin) {
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin != kNoBin && lane_id() == __ffs(peers) - 1)
    atomicAdd(hist + bin, __popc(peers));
}

struct Sum {
  template <class T>
  __device__ static T op(T a, T b) { return a + b; }
};
struct Min {
  template <class T>
  __device__ static T op(T a, T b) { return a < b ? a : b; }
};

// The block-wide reduction of v, returned to every thread; `buf` holds
// kWarps values.  Two barriers: buf is free again on return.
template <class Op, class T>
__device__ T block_reduce(T v, T* buf, T identity) {
  for (int o = 16; o > 0; o >>= 1)
    v = Op::op(v, __shfl_down_sync(kFull, v, o));
  if (lane_id() == 0) buf[warp_id()] = v;
  __syncthreads();
  T t = lane_id() < kWarps ? buf[lane_id()] : identity;
  for (int o = 16; o > 0; o >>= 1)
    t = Op::op(t, __shfl_down_sync(kFull, t, o));
  t = __shfl_sync(kFull, t, 0);
  __syncthreads();
  return t;
}

// The inclusive prefix sum of x in thread order, and the block's total.
// `buf` holds kWarps ints; callers alternate two buffers between
// consecutive calls, so one barrier suffices.
__device__ int block_scan(int x, int* buf, int& total) {
  const int lane = lane_id();
  int s = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += y;
  }
  if (lane == 31) buf[warp_id()] = s;
  __syncthreads();
  int w = lane < kWarps ? buf[lane] : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, w, o);
    if (lane >= o) w += y;
  }
  const int before = __shfl_sync(kFull, w, warp_id() == 0 ? 0 : warp_id() - 1);
  total = __shfl_sync(kFull, w, kWarps - 1);
  return (warp_id() == 0 ? 0 : before) + s;
}

// The sum of the bins of the lanes above this one, for a lane's 8 bins
// summing to `lsum` (warp 0 only).
__device__ __forceinline__ int bins_above(int lsum) {
  const int lane = lane_id();
  int suf = lsum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(kFull, suf, o);
    if (lane + o < 32) suf += y;
  }
  return suf - lsum;
}

// The picks of one radix pass, in shared memory.
struct Pick {
  int byte;    // the pass's byte of T
  int above;   // the grid's keys above T's prefix so far
  int k;       // the step's k (the first pass sets it)
  int mine;    // this block's keys above the pass's byte, in its prefix
};

// One radix pass's pick (kernels.py:181-189) from the grid's complete
// histogram `g` (coherent loads): the last byte b with above + #{hist >=
// b} >= k, and `above` plus the counts of the bins past it; `local`, the
// block's own histogram of the pass, gives the block's count past b.  The
// first pass also sets k = min(rem, the grid's ok nodes).  Warp 0
// computes; every thread reads the results after the trailing barrier.
__device__ void radix_pick(const int* g, const int* local, Pick* p,
                           bool first, int rem) {
  if (warp_id() == 0) {
    const int lane = lane_id();
    int h[8], lsum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = __ldcg(g + 8 * lane + j);
      lsum += h[j];
    }
    const int above = first ? 0 : p->above;
    int k = p->k;
    if (first) {
      int n_ok = lsum;
      for (int o = 16; o > 0; o >>= 1)
        n_ok += __shfl_xor_sync(kFull, n_ok, o);
      k = rem < n_ok ? rem : n_ok;
    }
    int t = 0, past = 0, mine = 0;
    if (k > 0) {
      int run = bins_above(lsum), ge = 0;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        run += h[j];
        ge += above + run >= k;
      }
      for (int o = 16; o > 0; o >>= 1) ge += __shfl_down_sync(kFull, ge, o);
      t = __shfl_sync(kFull, ge, 0) - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool past_t = 8 * lane + j > t;
        past += past_t ? h[j] : 0;
        mine += past_t ? local[8 * lane + j] : 0;
      }
      for (int o = 16; o > 0; o >>= 1) {
        past += __shfl_down_sync(kFull, past, o);
        mine += __shfl_down_sync(kFull, mine, o);
      }
    }
    if (lane == 0) {
      p->byte = t;
      p->above = above + past;
      p->k = k;
      p->mine = mine;
    }
  }
  __syncthreads();
}

// suf[b] = sum of local[b..255] for b in [0, 256], suf[256] = 0 (warp 0).
__device__ void store_suffix(const int* local, int* suf) {
  if (warp_id() == 0) {
    const int lane = lane_id();
    int h[8], lsum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = local[8 * lane + j];
      lsum += h[j];
    }
    int run = bins_above(lsum);
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      run += h[j];
      suf[8 * lane + j] = run;
    }
    if (lane == 0) suf[256] = 0;
  }
}

// The words in which spec u reserves a port: their indices and values,
// gathered once per spec into shared memory (any order: the fit is an
// AND over them, the commit an OR).
struct Resv {
  const int* j;
  const int32_t* v;
  int n;
};

// The network fit of spec u on node i (kernels.py:472-478): bandwidth,
// free dynamic ports, and no reserved port of the spec taken on the node
// (only the spec's nonzero words are read).
__device__ __forceinline__ bool net_fits(const RoundArgs& a, int u, int i,
                                         const Resv& r) {
  if ((int)((unsigned)a.bw_used[i] + (unsigned)a.mbits[u]) > a.bw_cap[i] ||
      a.dyn_free[i] < a.dyn_need[u])
    return false;
  const int32_t* row = a.port_words + (size_t)i * a.w;
  for (int q = 0; q < r.n; ++q)
    if (row[r.j[q]] & r.v[q]) return false;
  return true;
}

// Commits spec u on node i (kernels.py:526-573): usage, job count, the
// slot record at `dest` (slot mode) or the matrices, the network state.
__device__ __forceinline__ void commit(const RoundArgs& a, int u, int i,
                                       int dest, int4 ask, int32_t* jrow,
                                       bool net, const Resv& r) {
  const int n = (int)a.n, m = (int)a.slot_m;
  const int4 us = load4(a.used, i);
  const int coll = jrow[i];
  const bool scores = a.slot_scores != nullptr || a.commit_scores != nullptr;
  float base = 0.f;
  if (scores)
    base = nomad::score_fit(
        nomad::make_node(us, load4(a.cap, i),
                         reinterpret_cast<const float2*>(a.denom)[i]),
        ask);
  reinterpret_cast<int4*>(a.used)[i] =
      make_int4(us.x + ask.x, us.y + ask.y, us.z + ask.z, us.w + ask.w);
  jrow[i] = coll + 1;
  if (m > 0) {
    if (dest < m) {
      const size_t at = (size_t)u * m + dest;
      a.slots[at] = i;
      if (scores) {
        a.slot_scores[at] = base;
        a.slot_coll[at] = coll;
      }
    }
  } else {
    const size_t at = (size_t)u * n + i;
    a.placements[at] += 1;
    if (scores) {
      a.commit_scores[at] = base;
      a.commit_coll[at] = coll;
    }
  }
  if (net) {
    a.bw_used[i] = (int)((unsigned)a.bw_used[i] + (unsigned)a.mbits[u]);
    a.dyn_free[i] = (int)((unsigned)a.dyn_free[i] - (unsigned)a.dyn_need[u]);
    int32_t* row = a.port_words + (size_t)i * a.w;
    for (int q = 0; q < r.n; ++q) row[r.j[q]] |= r.v[q];
  }
}

// The value code of node i in column `col`, clipped into [0, V).
__device__ __forceinline__ int dp_code(const RoundArgs& a, int i, int col) {
  const int code = a.attr[(size_t)i * a.k_attr + col];
  const int v = (int)a.v;
  return code < 0 ? 0 : (code >= v ? v - 1 : code);
}

__global__ void __launch_bounds__(kThreads, 1)
    placement_rounds_kernel(RoundArgs a, Plan plan) {
  __shared__ int s_hist[256];
  __shared__ int s_buf[2][kWarps];
  __shared__ int s_red[kWarps];
  __shared__ long long s_red64[kWarps];
  __shared__ Pick s_pick;
  __shared__ int s_resv_j[kMaxPortWords];
  __shared__ int32_t s_resv_v[kMaxPortWords];
  __shared__ int s_resv_n;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, blk = blockIdx.x, nblk = plan.blocks;
  const int n = (int)a.n, u_pad = (int)a.u;
  const uint32_t seed = (uint32_t)a.seed;
  // This block's nodes [lo, hi), and where their keys and flags live
  // (indexed i - lo).
  const int lo = (int)min((long long)blk * plan.chunk, (long long)n);
  const int hi = (int)min((long long)lo + plan.chunk, (long long)n);
  uint32_t* keys = a.key + lo;
  uint8_t* flags = a.flag + lo;
  if (plan.smem_keys) {
    keys = reinterpret_cast<uint32_t*>(nomad_round_smem);
    flags = nomad_round_smem + (size_t)4 * plan.chunk;
  }
  int* const hist_sets = a.grid;                       // [3][4][256]
  int* const blk_above = a.grid + 3 * kHistSet;        // [G]
  int* const blk_suf = blk_above + nblk;               // [G][257]
  int* const blk_keep = blk_suf + 257 * nblk;          // [G]
  int* const blk_fit = blk_keep + nblk;                // [G]
  const int gtid = blk * kThreads + tid, gstride = nblk * kThreads;

  // Zero the histogram sets and the distinct_property table; the first
  // round test's barrier publishes it.
  for (int j = gtid; j < 3 * kHistSet; j += gstride) __stcg(hist_sets + j, 0);
  if (a.dp_pick != nullptr)
    for (int j = gtid; j < (int)a.v; j += gstride)
      __stcg(a.dp_pick + j, 0ull);

  // The round test (kernels.py:615-634): asks left, and a node fits the
  // dimension-wise smallest ask of the specs with work left.  Two grid
  // barriers: the first publishes `remaining`, the second the blocks'
  // fits.
  auto round_test = [&]() -> bool {
    grid.sync();
    int mn[4] = {kAskNone, kAskNone, kAskNone, kAskNone};
    long long left = 0;
    for (int u = tid; u < u_pad; u += kThreads) {
      const int r = __ldcg(a.remaining + u);
      if (r > 0) {
        const int4 q = load4(a.ask, u);
        mn[0] = min(mn[0], q.x);
        mn[1] = min(mn[1], q.y);
        mn[2] = min(mn[2], q.z);
        mn[3] = min(mn[3], q.w);
        left += r;
      }
    }
    left = block_reduce<Sum>(left, s_red64, 0ll);
#pragma unroll
    for (int d = 0; d < 4; ++d) mn[d] = block_reduce<Min>(mn[d], s_red, kAskNone);
    bool fits_any = false;
    for (int i = lo + tid; i < hi; i += kThreads) {
      const int4 us = load4(a.used, i), cp = load4(a.cap, i);
      fits_any |= mn[0] <= cp.x - us.x && mn[1] <= cp.y - us.y &&
                  mn[2] <= cp.z - us.z && mn[3] <= cp.w - us.w;
    }
    fits_any = __syncthreads_or(fits_any);
    if (tid == 0) blk_fit[blk] = fits_any ? 1 : 0;
    grid.sync();
    bool any = false;
    for (int j = tid; j < nblk; j += kThreads) any |= __ldcg(blk_fit + j) != 0;
    return __syncthreads_or(any) && left > 0;
  };

  int rounds = 0, steps = 0, attempt = 0;
  bool go = a.max_rounds > 0 && round_test();
  while (go) {
    int progress = 0;
    for (int u = 0; u < u_pad; ++u) {
      const int rem = __ldcg(a.remaining + u);
      if (rem <= 0) continue;
      int* const hists = hist_sets + (attempt % 3) * kHistSet;
      int* const stale = hist_sets + ((attempt + 2) % 3) * kHistSet;
      ++attempt;
      const int4 ask = load4(a.ask, u);
      const float pen = a.penalty[u];
      const bool dh = a.dh[u] != 0;
      int32_t* jrow = a.job_counts + (size_t)a.ji[u] * n;
      const bool net = a.net_active != nullptr && a.net_active[u] != 0;
      Resv resv{s_resv_j, s_resv_v, 0};
      if (net) {   // the spec's reserved-port words (kernels.py:328)
        if (tid == 0) s_resv_n = 0;
        __syncthreads();
        const int32_t* rw = a.resv_words + (size_t)u * a.w;
        for (int j = tid; j < (int)a.w; j += kThreads) {
          const int32_t x = rw[j];
          if (x != 0) {
            const int at = atomicAdd(&s_resv_n, 1);
            s_resv_j[at] = j;
            s_resv_v[at] = x;
          }
        }
        __syncthreads();
        resv.n = s_resv_n;
      }
      const bool dp = a.dp_active != nullptr && a.dp_active[u] != 0;
      const int col = dp ? a.dp_col[u] : 0;
      uint8_t* dp_row = dp ? a.dp_used + (size_t)u * a.v : nullptr;
      const uint8_t* feas_row = a.feas + (size_t)u * n;

      // Pass 0: the ok mask, the keys and the first byte's histogram.
      for (int b = tid; b < 256; b += kThreads) s_hist[b] = 0;
      __syncthreads();
      for (int base = lo; base < hi; base += kThreads) {
        const int i = base + tid;
        int bin = kNoBin;
        if (i < hi) {
          const int4 us = load4(a.used, i);
          const nomad::Node nd = nomad::make_node(
              us, load4(a.cap, i), reinterpret_cast<const float2*>(a.denom)[i]);
          const int coll = jrow[i];
          bool ok = feas_row[i] != 0 && nomad::fits(nd, ask);
          if (dh && coll != 0) ok = false;
          if (ok && net) ok = net_fits(a, u, i, resv);
          if (ok && dp) {
            const int code = a.attr[(size_t)i * a.k_attr + col];
            ok = code != kMissing && __ldcg(dp_row + dp_code(a, i, col)) == 0;
          }
          uint32_t key = 0;
          if (ok) {
            key = ordered_key(nomad::commit_score(nomad::score_fit(nd, ask),
                                                  pen, coll, seed,
                                                  (uint32_t)u, (uint32_t)i));
            bin = (int)(key >> 24);
          }
          keys[i - lo] = key;
          flags[i - lo] = ok ? 1 : 0;
        }
        hist_add(s_hist, bin);
      }
      __syncthreads();
      for (int b = tid; b < 256; b += kThreads)
        if (s_hist[b] != 0) atomicAdd(hists + b, s_hist[b]);
      grid.sync();
      // Every read of the set two steps old is done: zero it for the step
      // after next.
      for (int j = gtid; j < kHistSet; j += gstride) __stcg(stale + j, 0);
      radix_pick(hists, s_hist, &s_pick, true, rem);
      const int k = s_pick.k;
      if (k <= 0) continue;
      if (!dp && blk == 0 && tid == 0) a.remaining[u] = rem - k;

      // Passes 1-3: the k-th largest key T, a byte at a time
      // (kernels.py:191-201).  A block's keys above T are those above
      // the pass's byte in each pass's prefix.
      uint32_t prefix = (uint32_t)s_pick.byte;
      int my_above = s_pick.mine;
      for (int pass = 1; pass < 4; ++pass) {
        const int known = 32 - 8 * pass, shift = known - 8;
        int* const g = hists + pass * 256;
        for (int b = tid; b < 256; b += kThreads) s_hist[b] = 0;
        __syncthreads();
        for (int base = lo; base < hi; base += kThreads) {
          const int i = base + tid;
          int bin = kNoBin;
          if (i < hi && flags[i - lo]) {
            const uint32_t key = keys[i - lo];
            if ((key >> known) == prefix) bin = (int)((key >> shift) & 0xFF);
          }
          hist_add(s_hist, bin);
        }
        __syncthreads();
        for (int b = tid; b < 256; b += kThreads)
          if (s_hist[b] != 0) atomicAdd(g + b, s_hist[b]);
        if (pass == 3) {
          // What the blocks after this one need for their carries.
          store_suffix(s_hist, blk_suf + 257 * blk);
          if (tid == 0) blk_above[blk] = my_above;
        }
        grid.sync();
        radix_pick(g, s_hist, &s_pick, false, rem);
        prefix = (prefix << 8) | (uint32_t)s_pick.byte;
        my_above += s_pick.mine;
      }
      const uint32_t thresh = prefix;
      const int need = k - s_pick.above;   // taken from the == T band
      const int offset = a.count[u] - rem;   // placed so far
      const int t0 = s_pick.byte;

      // The blocks before this one: their keys above T and in the band.
      int gt_before = 0, band_before = 0;
      for (int j = tid; j < blk; j += kThreads) {
        const int* suf = blk_suf + 257 * j;
        const int ge = __ldcg(suf + t0), gt = __ldcg(suf + t0 + 1);
        gt_before += __ldcg(blk_above + j) + gt;
        band_before += ge - gt;
      }
      gt_before = block_reduce<Sum>(gt_before, s_red, 0);
      band_before = block_reduce<Sum>(band_before, s_red, 0);

      // Select in node order: the keys above T and the first `need` of
      // the band; without distinct_property, commit at once.  The scan
      // packs the tile's above-T count (high half) and band count (low
      // half).
      int carry_gt = gt_before, carry_band = band_before, t_buf = 0;
      for (int base = lo; base < hi; base += kThreads) {
        const int i = base + tid;
        bool gt = false, band = false;
        if (i < hi && flags[i - lo]) {
          const uint32_t key = keys[i - lo];
          gt = key > thresh;
          band = key == thresh;
        }
        int total;
        const int incl = block_scan((gt ? 1 << 16 : 0) | (band ? 1 : 0),
                                    s_buf[t_buf], total);
        t_buf ^= 1;
        const int g = carry_gt + (incl >> 16), b = carry_band + (incl & 0xFFFF);
        carry_gt += total >> 16;
        carry_band += total & 0xFFFF;
        const bool sel = gt || (band && b <= need);
        if (dp) {
          if (i < hi) {
            flags[i - lo] = sel ? 2 : 0;
            // Per value the best key, then the lowest node index
            // (kernels.py:512-525), as one 64-bit maximum.
            if (sel)
              atomicMax(a.dp_pick + dp_code(a, i, col),
                        (unsigned long long)keys[i - lo] << 32 |
                            (0xFFFFFFFFu - (uint32_t)i));
          }
        } else if (sel) {
          commit(a, u, i, offset + g + (b < need ? b : need) - 1, ask, jrow,
                 net, resv);
        }
      }
      int placed = k;
      if (dp) {
        grid.sync();
        int my_keep = 0;
        for (int i = lo + tid; i < hi; i += kThreads) {
          if (flags[i - lo] == 2) {
            const bool keep =
                __ldcg(a.dp_pick + dp_code(a, i, col)) ==
                ((unsigned long long)keys[i - lo] << 32 |
                 (0xFFFFFFFFu - (uint32_t)i));
            flags[i - lo] = keep ? 3 : 0;
            my_keep += keep;
          }
        }
        my_keep = block_reduce<Sum>(my_keep, s_red, 0);
        if (tid == 0) blk_keep[blk] = my_keep;
        grid.sync();
        // Every read of the table is done: clear this block's share.
        for (int j = gtid; j < (int)a.v; j += gstride) __stcg(a.dp_pick + j, 0ull);
        int before = 0, all = 0;
        for (int j = tid; j < nblk; j += kThreads) {
          const int c = __ldcg(blk_keep + j);
          all += c;
          before += j < blk ? c : 0;
        }
        before = block_reduce<Sum>(before, s_red, 0);
        all = block_reduce<Sum>(all, s_red, 0);
        int carry = before;
        for (int base = lo; base < hi; base += kThreads) {
          const int i = base + tid;
          const bool keep = i < hi && flags[i - lo] == 3;
          int total;
          const int pos = carry + block_scan(keep ? 1 : 0, s_buf[t_buf], total);
          t_buf ^= 1;
          carry += total;
          if (keep) {
            commit(a, u, i, offset + pos - 1, ask, jrow, net, resv);
            dp_row[dp_code(a, i, col)] = 1;
          }
        }
        placed = all;
        if (blk == 0 && tid == 0) a.remaining[u] = rem - placed;
      }
      progress += placed;
      ++steps;
      __syncthreads();
    }
    ++rounds;
    go = progress > 0 && rounds < a.max_rounds && round_test();
  }
  if (blk == 0 && tid == 0) {
    a.status[0] = rounds;
    a.status[1] = steps;
    a.status[2] = nblk;
    a.status[3] = plan.smem_keys;
  }
}

}  // namespace

// Runs the placement loop on `stream` in one cooperative launch and
// returns its cudaError_t (0 on success).  `args` is a host pointer to the
// RoundArgs the wrapper filled; its pointers are device pointers, and
// `grid` holds room for max_blocks blocks.  The grid: one block a tile of
// kThreads nodes, at most max_blocks and the SMs, all resident (the
// occupancy query); a launch the card refuses returns its error and
// nothing runs.  (A void pointer: a parameter of the anonymous
// namespace's type would give the entry point internal linkage.)
extern "C" int nomad_placement_rounds(const void* args, void* stream) {
  RoundArgs a = *static_cast<const RoundArgs*>(args);
  if (a.u <= 0 || a.n <= 0 || a.max_blocks <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, placement_rounds_kernel);
  if (err != cudaSuccess) return (int)err;
  long long g = (a.n + kThreads - 1) / kThreads;
  g = g < sms ? g : sms;
  g = g < a.max_blocks ? g : a.max_blocks;
  Plan plan;
  plan.blocks = (int)g;
  plan.chunk = (int)((a.n + g - 1) / g);
  const size_t keys_bytes = ((size_t)5 * plan.chunk + 15) / 16 * 16;
  plan.smem_keys = fa.sharedSizeBytes + keys_bytes <= (size_t)optin;
  const size_t dyn = plan.smem_keys ? keys_bytes : 0;
  err = cudaFuncSetAttribute(placement_rounds_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, placement_rounds_kernel, kThreads, dyn);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < g) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a, &plan};
  return (int)cudaLaunchCooperativeKernel(placement_rounds_kernel,
                                          dim3(plan.blocks), dim3(kThreads),
                                          params, dyn, (cudaStream_t)stream);
}
