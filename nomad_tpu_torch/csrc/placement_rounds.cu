// placement_rounds: one round of the batch scheduler's rank-and-commit
// loop, written by hand for Hopper (sm_90a).
//
// Replaces the reference's schedule program, the XLA while/scan
// nomad_tpu/ops/kernels.py:_placement_rounds_impl (:412), with its exact
// top-k _select_top_k (:157) and byte histograms (:124-154); there is no
// pallas_call.  One launch runs one round: every spec in order, so spec
// u + 1 sees spec u's commit.  For each spec with work left:
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
// At the round's end it writes the round's status: the allocs placed,
// the asks left, whether any node fits the dimension-wise smallest ask
// still wanted (the reference's min-ask exit, :615-634, tested for the
// next round), and the committing steps.  The wrapper reads those four
// ints once a round; nothing else crosses to the host.
//
// What bounds it on an H100.  Per committing step the kernel must read
// each node's used, cap (16 B each), denom (8 B), feas (1 B) and job
// count (4 B) once, 45 B a node (more with networks and
// distinct_property), and write the k committed rows.  At config (b)
// (10,112 nodes) that is 0.46 MB a step, 0.14 us at 3.35 TB/s.  The
// chain of dependent block-wide steps (a histogram, a scan, a barrier)
// sets the pace, not the bytes.
//
// Design.  One block of kThreads threads runs the whole round, so the
// barriers between a spec's phases are __syncthreads, not grid barriers
// (no cooperative launch, no -rdc).  Thread t owns nodes t, t + kThreads,
// ... in every phase: it reads back its own scratch (key, flag) and its
// own rows of used, job counts and net state, so only the histograms,
// the scans and the distinct_property tables cross threads.  Histograms
// are 256 shared-memory bins fed by warp-aggregated atomics
// (__match_any_sync: one atomic per distinct byte in a warp, since the
// scores' high bytes mostly agree).  The == T band's prefix and the slot
// destinations come from one block scan per tile of kThreads nodes, in
// node order, with a carry across tiles.  The scores are score_common's
// functions (make_node, fits, score_fit, commit_score): the bits of
// scored_rows, so the kernel equals the eager loop bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

// The block's threads: 1,024 on the card (device.py sets nothing);
// tests/test_torch_round_source.py also builds the source with g++ at 64,
// against a CPU mock of the runtime.
#ifndef NOMAD_ROUND_THREADS
#define NOMAD_ROUND_THREADS 1024
#endif

namespace {

constexpr int kThreads = NOMAD_ROUND_THREADS;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kWarps <= 32, "one warp scans the warps");
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNoBin = 256;        // a lane that adds to no histogram bin
constexpr int kMissing = -1;       // ops/encode.py MISSING
constexpr int kAskNone = 1 << 30;  // the min-ask of a spec with no work left
constexpr int kMaxPortWords = 2048;  // 65,536 ports a bit each (W <= this)

// The kernel's arguments.  Every field is 8 bytes, in the order of
// _ROUND_FIELDS in ops/fused_score.py, which builds it with ctypes.  A
// null network or distinct_property pointer means the batch has none;
// placements/commit_* are null in slot mode, slots/slot_* in matrix mode,
// and the score outputs without scores.
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
  uint32_t* key;              // [N] scratch: the ok nodes' keys
  uint8_t* flag;              // [N] scratch: 1 ok, 2 selected, 3 dp pick
  uint32_t* dp_best;          // [V] scratch
  int32_t* dp_first;          // [V] scratch
  int32_t* status;            // [4]: placed, asks left, fits, steps
  int64_t u, n, w, k_attr, v, slot_m, seed;
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// float order == unsigned order of the image (kernels.py:176-178).
__device__ __forceinline__ uint32_t ordered_key(float s) {
  const uint32_t b = __float_as_uint(s);
  return (b >> 31) == 0 ? (b | 0x80000000u) : ~b;
}

// Coherent loads of rows this launch writes (never __ldg).
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
  __device__ static int op(int a, int b) { return a + b; }
};
struct Min {
  __device__ static int op(int a, int b) { return a < b ? a : b; }
};

// The block-wide reduction of v, returned to every thread; `buf` holds
// kWarps ints.  Two barriers: buf is free again on return.
template <class Op>
__device__ int block_reduce(int v, int* buf, int identity) {
  for (int o = 16; o > 0; o >>= 1) v = Op::op(v, __shfl_down_sync(kFull, v, o));
  if (lane_id() == 0) buf[warp_id()] = v;
  __syncthreads();
  int t = lane_id() < kWarps ? buf[lane_id()] : identity;
  for (int o = 16; o > 0; o >>= 1) t = Op::op(t, __shfl_down_sync(kFull, t, o));
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

// One radix pass's pick (kernels.py:181-189): from the complete
// histogram, the last byte b with above + #{hist >= b} >= k, and `above`
// plus the counts of the bins past it.  Warp 0 computes; every thread
// gets the results after the trailing barrier.
__device__ void radix_pick(const int* hist, int k, int* s_pick) {
  if (warp_id() == 0) {
    const int lane = lane_id();
    const int above = s_pick[1];
    int h[8], lsum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = hist[8 * lane + j];
      lsum += h[j];
    }
    // Sum of the bins of the lanes above this one.
    int suf = lsum;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(kFull, suf, o);
      if (lane + o < 32) suf += y;
    }
    int run = suf - lsum, ge = 0;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      run += h[j];
      ge += above + run >= k;
    }
    for (int o = 16; o > 0; o >>= 1) ge += __shfl_down_sync(kFull, ge, o);
    const int t = __shfl_sync(kFull, ge, 0) - 1;
    int past = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) past += 8 * lane + j > t ? h[j] : 0;
    for (int o = 16; o > 0; o >>= 1) past += __shfl_down_sync(kFull, past, o);
    if (lane == 0) {
      s_pick[0] = t;
      s_pick[1] = above + past;
    }
  }
  __syncthreads();
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

__global__ void __launch_bounds__(kThreads, 1)
    placement_round_kernel(RoundArgs a) {
  __shared__ int s_hist[256];
  __shared__ int s_buf[2][kWarps];
  __shared__ int s_red[kWarps];
  __shared__ int s_pick[2];   // the radix pass's byte, and `above`
  __shared__ int s_resv_j[kMaxPortWords];
  __shared__ int32_t s_resv_v[kMaxPortWords];
  __shared__ int s_resv_n;
  const int tid = threadIdx.x;
  const int n = (int)a.n, u_pad = (int)a.u, v_pad = (int)a.v;
  const int k_attr = (int)a.k_attr;
  const int tiles = (n + kThreads - 1) / kThreads;
  const uint32_t seed = (uint32_t)a.seed;
  int progress = 0, steps = 0;   // thread 0's

  for (int u = 0; u < u_pad; ++u) {
    const int rem = a.remaining[u];
    if (rem <= 0) continue;
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
    uint8_t* dp_row = dp ? a.dp_used + (size_t)u * v_pad : nullptr;
    const uint8_t* feas_row = a.feas + (size_t)u * n;

    // The ok mask, the keys and the first byte's histogram.
    for (int b = tid; b < 256; b += kThreads) s_hist[b] = 0;
    if (tid == 0) s_pick[1] = 0;
    __syncthreads();
    int my_ok = 0;
    for (int t = 0; t < tiles; ++t) {
      const int i = t * kThreads + tid;
      int bin = kNoBin;
      if (i < n) {
        const int4 us = load4(a.used, i);
        const nomad::Node nd = nomad::make_node(
            us, load4(a.cap, i), reinterpret_cast<const float2*>(a.denom)[i]);
        const int coll = jrow[i];
        bool ok = feas_row[i] != 0 && nomad::fits(nd, ask);
        if (dh && coll != 0) ok = false;
        if (ok && net) ok = net_fits(a, u, i, resv);
        if (ok && dp) {
          const int code = a.attr[(size_t)i * k_attr + col];
          const int cc = code < 0 ? 0 : (code >= v_pad ? v_pad - 1 : code);
          ok = code != kMissing && dp_row[cc] == 0;
        }
        uint32_t key = 0;
        if (ok) {
          key = ordered_key(nomad::commit_score(nomad::score_fit(nd, ask), pen,
                                                coll, seed, (uint32_t)u,
                                                (uint32_t)i));
          bin = (int)(key >> 24);
          ++my_ok;
        }
        a.key[i] = key;
        a.flag[i] = ok ? 1 : 0;
      }
      hist_add(s_hist, bin);
    }
    const int n_ok = block_reduce<Sum>(my_ok, s_red, 0);
    const int k = rem < n_ok ? rem : n_ok;
    if (k <= 0) continue;

    // The k-th largest key T, a byte at a time (kernels.py:191-201).
    radix_pick(s_hist, k, s_pick);
    uint32_t prefix = (uint32_t)s_pick[0];
    for (int pass = 1; pass < 4; ++pass) {
      const int known = 32 - 8 * pass, shift = known - 8;
      for (int b = tid; b < 256; b += kThreads) s_hist[b] = 0;
      __syncthreads();
      for (int t = 0; t < tiles; ++t) {
        const int i = t * kThreads + tid;
        int bin = kNoBin;
        if (i < n && a.flag[i]) {
          const uint32_t key = a.key[i];
          if ((key >> known) == prefix) bin = (int)((key >> shift) & 0xFF);
        }
        hist_add(s_hist, bin);
      }
      __syncthreads();
      radix_pick(s_hist, k, s_pick);
      prefix = (prefix << 8) | (uint32_t)s_pick[0];
    }
    const uint32_t thresh = prefix;
    const int need = k - s_pick[1];   // taken from the == T band
    const int offset = a.count[u] - rem;   // placed so far

    // Select in node order: the keys above T and the first `need` of the
    // band; without distinct_property, commit at once.  The scan packs
    // the tile's above-T count (high half) and band count (low half).
    int carry_gt = 0, carry_band = 0, t_buf = 0;
    for (int t = 0; t < tiles; ++t) {
      const int i = t * kThreads + tid;
      bool gt = false, band = false;
      if (i < n && a.flag[i]) {
        const uint32_t key = a.key[i];
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
        if (i < n) a.flag[i] = sel ? 2 : 0;
      } else if (sel) {
        commit(a, u, i, offset + g + (b < need ? b : need) - 1, ask, jrow,
               net, resv);
      }
    }
    int placed = k;
    if (dp) {
      // Per property value the best selected key, then the lowest node
      // index among the selected nodes that reach it (kernels.py:512-525).
      const uint32_t neg_inf = ordered_key(nomad::kNegInf);
      for (int c = tid; c < v_pad; c += kThreads) {
        __stcg(a.dp_best + c, neg_inf);
        __stcg(a.dp_first + c, n + 1);
      }
      __syncthreads();
      for (int t = 0; t < tiles; ++t) {
        const int i = t * kThreads + tid;
        if (i < n && a.flag[i] == 2) {
          const int code = a.attr[(size_t)i * k_attr + col];
          const int cc = code < 0 ? 0 : (code >= v_pad ? v_pad - 1 : code);
          atomicMax(a.dp_best + cc, a.key[i]);
        }
      }
      __syncthreads();
      for (int t = 0; t < tiles; ++t) {
        const int i = t * kThreads + tid;
        if (i < n && a.flag[i] == 2) {
          const int code = a.attr[(size_t)i * k_attr + col];
          const int cc = code < 0 ? 0 : (code >= v_pad ? v_pad - 1 : code);
          if (a.key[i] >= __ldcg(a.dp_best + cc)) {
            a.flag[i] = 3;
            atomicMin(a.dp_first + cc, i);
          }
        }
      }
      __syncthreads();
      int carry = 0;
      for (int t = 0; t < tiles; ++t) {
        const int i = t * kThreads + tid;
        bool keep = false;
        int cc = 0;
        if (i < n && a.flag[i] == 3) {
          const int code = a.attr[(size_t)i * k_attr + col];
          cc = code < 0 ? 0 : (code >= v_pad ? v_pad - 1 : code);
          keep = __ldcg(a.dp_first + cc) == i;
        }
        int total;
        const int pos = carry + block_scan(keep ? 1 : 0, s_buf[t_buf], total);
        t_buf ^= 1;
        carry += total;
        if (keep) {
          commit(a, u, i, offset + pos - 1, ask, jrow, net, resv);
          dp_row[cc] = 1;
        }
      }
      placed = carry;
    }
    if (tid == 0) {
      a.remaining[u] = rem - placed;
      progress += placed;
      ++steps;
    }
    __syncthreads();
  }

  // The round's status, and the min-ask test for the next round
  // (kernels.py:615-634): the dimension-wise smallest ask of the specs
  // with work left, against every node's free capacity.
  __syncthreads();
  int mn[4] = {kAskNone, kAskNone, kAskNone, kAskNone}, left = 0;
  for (int u = tid; u < u_pad; u += kThreads) {
    const int r = a.remaining[u];
    if (r > 0) {
      const int4 q = load4(a.ask, u);
      mn[0] = min(mn[0], q.x);
      mn[1] = min(mn[1], q.y);
      mn[2] = min(mn[2], q.z);
      mn[3] = min(mn[3], q.w);
      left += r;
    }
  }
  left = block_reduce<Sum>(left, s_red, 0);
#pragma unroll
  for (int d = 0; d < 4; ++d) mn[d] = block_reduce<Min>(mn[d], s_red, kAskNone);
  bool fits_any = false;
  for (int i = tid; i < n; i += kThreads) {
    const int4 us = load4(a.used, i), cp = load4(a.cap, i);
    fits_any |= mn[0] <= cp.x - us.x && mn[1] <= cp.y - us.y &&
                mn[2] <= cp.z - us.z && mn[3] <= cp.w - us.w;
  }
  fits_any = __syncthreads_or(fits_any);
  if (tid == 0) {
    a.status[0] = progress;
    a.status[1] = left;
    a.status[2] = fits_any ? 1 : 0;
    a.status[3] = steps;
  }
}

}  // namespace

// Launches one round on `stream` and returns the launch's cudaError_t (0
// on success).  `args` is a host pointer to the RoundArgs the wrapper
// filled; its pointers are device pointers.  (A void pointer: a
// parameter of the anonymous namespace's type would give the entry point
// internal linkage.)
extern "C" int nomad_placement_round(const void* args, void* stream) {
  RoundArgs a = *static_cast<const RoundArgs*>(args);
  if (a.u <= 0 || a.n <= 0) return 0;
  void* params[] = {&a};
  return (int)cudaLaunchKernel(placement_round_kernel, dim3(1),
                               dim3(kThreads), params, 0,
                               (cudaStream_t)stream);
}
