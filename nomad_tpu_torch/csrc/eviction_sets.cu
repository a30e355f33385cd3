// eviction_sets: the batched eviction-set pass of device preemption,
// written by hand for Hopper (sm_90a).
//
// Replaces the jitted XLA program nomad_tpu/ops/preempt.py:eviction_sets
// (a cumsum and a lax.scan over the alloc axis; no Pallas kernel).  For
// every (spec u, node n) pair, over node n's candidates in the oracle's
// order (priority ascending, largest first, id; sentinel priority in the
// padding):
//
//   need     = ask[u] - free[n]
//   k*       = (A + 1) - (all(need <= 0) + sum_k all(need <= cum[n, k]))
//   feasible = 1 <= k* <= #{a : prio[n, a] < job_prio[u]}
//   mask     = the prefix a < k* (when feasible), trimmed back to front:
//              drop a where all(need <= freed - sizes[n, a])
//   n_evict  = |mask|
//   score    = ScoreFit(used[n] - freed + ask[u], 0, denom[n])
//
// k* is the reference's own count of non-fitting prefixes, not "the first
// prefix that fits": the two agree while sizes are non-negative, and the
// count keeps the result bit-identical to the plain version
// (ops/preempt.py:eviction_sets_reference) when they are not.  All of it
// is int32 arithmetic but the score, whose int32 sum is taken before the
// float conversion, as the reference does.
//
// What bounds it on an H100.  Each pair writes A + 1 + 4 + 4 bytes (mask,
// feasible, n_evict, score); each node reads 40 bytes (free, used, denom)
// and 20 per candidate (prio, sizes).  At config_preempt (U = 50 specs,
// N = 10,112, A = 8) that is 8.6 MB written and 2.0 MB read: 3.2 us at
// 3.35 TB/s.  The arithmetic (about 30 integer operations a candidate and
// one ScoreFit a pair) is far below the card's integer rate, so bytes and
// the launch bound it.
//
// Design: the simple kernel.  One thread per (u, n): x runs over nodes in
// blocks of 128, y over specs (U <= 65535, checked by the wrapper and
// here).  A thread loads its node's free, used and denom once and reads
// prio and sizes (one int4 a candidate) through __ldg; every spec re-reads
// them, from L1 or L2.  It walks the candidates three times (the forward
// count, the prefix sum of the chosen set, the backward trim) and writes
// each mask byte as the trim decides it, so no local array is needed.
// The score is score_common.cuh's score_fit, the one home of ScoreFit on
// the card, so the pass scores bit for bit like the score kernels and the
// plain version on the card.  Sharing sizes across specs in shared memory,
// TMA and vector stores of the mask are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

namespace {

constexpr int kThreads = 128;

struct EvictArgs {
  const int4* free;
  const int4* used;
  const float2* denom;
  const int32_t* prio;
  const int4* sizes;
  const int4* ask;
  const int32_t* job_prio;
  int u, n, a;
  uint8_t* mask;
  uint8_t* feasible;
  int32_t* n_evict;
  float* score;
};

__device__ __forceinline__ int4 sub4(int4 x, int4 y) {
  return make_int4(x.x - y.x, x.y - y.y, x.z - y.z, x.w - y.w);
}

__device__ __forceinline__ int4 add4(int4 x, int4 y) {
  return make_int4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// x <= y on all four dimensions.
__device__ __forceinline__ bool le4(int4 x, int4 y) {
  return x.x <= y.x && x.y <= y.y && x.z <= y.z && x.w <= y.w;
}

__global__ void __launch_bounds__(kThreads)
    eviction_sets_kernel(EvictArgs g) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= g.n) return;
  const int u = blockIdx.y;
  const int A = g.a;
  const int4 ask = __ldg(g.ask + u);
  const int jp = __ldg(g.job_prio + u);
  const int4 need = sub4(ask, __ldg(g.free + n));
  const int4 zero = make_int4(0, 0, 0, 0);
  const int32_t* prio = g.prio + (size_t)n * A;
  const int4* sizes = g.sizes + (size_t)n * A;

  // Forward: the fitting prefixes (k = 0 frees nothing) and the
  // candidates below the spec's priority.
  int fits = le4(need, zero) ? 1 : 0;
  int ncand = 0;
  int4 cum = zero;
  for (int k = 0; k < A; ++k) {
    cum = add4(cum, __ldg(sizes + k));
    fits += le4(need, cum) ? 1 : 0;
    ncand += __ldg(prio + k) < jp ? 1 : 0;
  }
  const int kstar = (A + 1) - fits;
  const bool feasible = kstar >= 1 && kstar <= ncand;

  // The freed capacity of the chosen prefix.
  int4 freed = zero;
  if (feasible) {
    for (int k = 0; k < kstar; ++k) freed = add4(freed, __ldg(sizes + k));
  }

  // Backward trim, from the last candidate to the first.
  uint8_t* mask = g.mask + ((size_t)u * g.n + n) * A;
  int evict = 0;
  for (int k = A - 1; k >= 0; --k) {
    const bool in_set = feasible && k < kstar;
    bool keep = false;
    if (in_set) {
      const int4 sz = __ldg(sizes + k);
      const int4 without = sub4(freed, sz);
      if (le4(need, without)) {
        freed = without;
      } else {
        keep = true;
      }
    }
    mask[k] = keep ? 1 : 0;
    evict += keep ? 1 : 0;
  }

  // Post-eviction ScoreFit: used - freed + ask in int32, then the shared
  // ScoreFit with a zero ask.
  const int4 after = add4(sub4(__ldg(g.used + n), freed), ask);
  nomad::Node nd;
  nd.free = zero;
  nd.used_cpu = (float)after.x;
  nd.used_mem = (float)after.y;
  nd.denom = __ldg(g.denom + n);
  const size_t cell = (size_t)u * g.n + n;
  g.feasible[cell] = feasible ? 1 : 0;
  g.n_evict[cell] = evict;
  g.score[cell] = nomad::score_fit(nd, zero);
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on
// success).  Pointers are device pointers; free, used, sizes and ask must
// be 16-byte aligned, denom 8-byte (the wrapper checks).  Outputs: mask
// [u, n, a] and feasible [u, n] as bytes, n_evict [u, n] int32, score
// [u, n] float.  u <= 65535.
extern "C" int nomad_eviction_sets(const int32_t* free, const int32_t* used,
                                   const float* denom, const int32_t* prio,
                                   const int32_t* sizes, const int32_t* ask,
                                   const int32_t* job_prio, int u, int n,
                                   int a, uint8_t* mask, uint8_t* feasible,
                                   int32_t* n_evict, float* score,
                                   void* stream) {
  if (u <= 0 || n <= 0) return 0;
  if (u > 65535 || a <= 0) return (int)cudaErrorInvalidValue;
  EvictArgs g;
  g.free = reinterpret_cast<const int4*>(free);
  g.used = reinterpret_cast<const int4*>(used);
  g.denom = reinterpret_cast<const float2*>(denom);
  g.prio = prio;
  g.sizes = reinterpret_cast<const int4*>(sizes);
  g.ask = reinterpret_cast<const int4*>(ask);
  g.job_prio = job_prio;
  g.u = u;
  g.n = n;
  g.a = a;
  g.mask = mask;
  g.feasible = feasible;
  g.n_evict = n_evict;
  g.score = score;
  const dim3 grid((n + kThreads - 1) / kThreads, u);
  void* args[] = {&g};
  return (int)cudaLaunchKernel((const void*)eviction_sets_kernel, grid,
                               dim3(kThreads), args, 0,
                               (cudaStream_t)stream);
}
