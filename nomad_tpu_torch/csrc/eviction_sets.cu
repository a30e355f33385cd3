// eviction_sets: the batched eviction-set pass of device preemption,
// written by hand for Hopper (sm_90a).
//
// Replaces the jitted XLA program nomad_tpu/ops/preempt.py:82
// (eviction_sets: a cumsum and a lax.scan over the alloc axis; no Pallas
// kernel).  For every (spec u, node n) pair, over node n's candidates in
// the oracle's order (priority ascending, largest first, id; sentinel
// priority in the padding):
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
// What bounds it on an H100: bytes, by the count of chip_smoke.py's
// evict_bytes.  Each pair writes A + 1 + 4 + 4 bytes (mask, feasible,
// n_evict, score); each node reads 40 bytes (free, used, denom) and 20 per
// candidate (prio, sizes).  At config_preempt (U = 50 specs, N = 10,112,
// A = 8) that is 8.6 MB written and 2.0 MB read: 3.2 us at 3.35 TB/s; at
// U = 128 and A = 16, 36.0 MB: 10.7 us.  Measured on an H100, what the
// card spends beyond that is the launch with the tile's staging (about
// 3 us) and the work of the pairs (the search, the trim, one ScoreFit
// with two powf), under which the stores mostly hide; the shares and the
// ablations that show it are in PERF.md.
//
// The design, against what held the first kernel (one thread a pair,
// walking its node's candidates three times at a stride of A * 16 bytes
// between lanes, every spec re-reading them from L2, the mask written a
// byte at a time):
// - A block owns a tile of T = 32 nodes and a chunk of specs; its warps
//   share the tile and split the chunk.  The tile's sizes and prio rows,
//   contiguous spans of global memory, are staged once in shared memory
//   by coalesced loads (16 bytes a candidate's sizes), with the chunk's
//   asks and job priorities; every spec of the chunk is served from
//   there.  Rows are padded to an odd stride, so lanes on consecutive
//   nodes reading the same candidate hit distinct banks.  free, used and
//   denom are one coalesced load a lane, kept in registers.
// - The spec-independent work is done once a node, four lanes a node (one
//   a dimension): the prefix sums C[j] (C[0] = 0) into shared memory, in
//   int32 as the reference sums them, and whether the node is regular --
//   C non-decreasing in every dimension and the priorities non-decreasing,
//   as sort_candidates gives them.  On a regular node the fitting prefixes
//   are an upper set, so k* is found by binary search over C (unrolled at
//   a power-of-two A, log2(A) + 1 probes), feasible is one priority test
//   (candidate k* - 1 below the spec's), the freed capacity is C[k*], and
//   the trim starts one below k* - 1 (that one stays: without it the
//   prefix k* - 1 would fit).  A node that is not regular (a negative
//   size, a sum that wraps, unsorted priorities) takes the reference's
//   full count: every prefix, the candidate count, the prefix sum, the
//   trim from k* - 1.
// - Lanes run over nodes, so a warp's spec is uniform: its ask is a
//   broadcast read and its outputs for the spec are contiguous.  The mask
//   of a pair is built in a register (a bit a candidate) and written as one
//   A-byte vector store (A = 8: 8 bytes; 16: one 16-byte store), aligned
//   because the pair's offset is a multiple of A: a warp writes 32 * A
//   contiguous bytes an instruction, feasible 32, n_evict and score 128.
// - Widths by A: instantiated for A = 1, 2, 4, ..., 64 with T = 32 (the
//   search unrolled, the mask in one register and one vector store); a
//   generic instantiation takes any other A, with the tile's nodes halved
//   (32, 16, ..., 1) until the staged rows fit the block's shared memory
//   (lanes then spread over (node, spec) pairs) and the mask written a
//   byte at a time.  Past one node's rows in shared memory (A above about
//   6,000) it reads the rows in place, every node taking the full count.
//   Shared memory above 48 KB is dynamic, after cudaFuncSetAttribute.
// - The grid: ceil(N / T) node tiles by spec chunks, as many chunks as
//   leave every block resident at once (the occupancy of the chosen
//   instantiation), so no block's staging waits behind another's work.
// The score is score_common.cuh's score_fit, the one home of ScoreFit on
// the card, so the pass scores bit for bit like the score kernels and the
// plain version on the card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 6;         // blocks per SM the registers allow
constexpr int kMaxChunk = 1024;       // specs of one block, at most
constexpr int kWideTile = 32;         // nodes of a tile, lanes of a warp
// Shared memory a block may ask for: the card's 227 KB less a margin.
constexpr int kSmemBudget = 220 * 1024;

struct EvictArgs {
  const int4* free;
  const int4* used;
  const float2* denom;
  const int32_t* prio;
  const int4* sizes;
  const int4* ask;
  const int32_t* job_prio;
  int u, n, a;
  int tile;      // T: nodes of a block (generic instantiation; 32 else)
  int chunk;     // specs of a block
  int staged;    // the rows are in shared memory (else read in place)
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

// A staged row's stride: A + 1 (the prefix sums' leading zero) rounded up
// to an odd count of elements.
__host__ __device__ __forceinline__ int row_stride(int a) {
  return (a + 1) | 1;
}

// Shared memory of a block: the tile's sizes, prefix-sum and prio rows,
// the chunk's asks and job priorities, a flag a node.
__host__ __device__ __forceinline__ size_t smem_bytes(int tile, int a,
                                                      int chunk,
                                                      bool staged) {
  const size_t rows = staged ? (size_t)tile * row_stride(a) : 0;
  return rows * (2 * sizeof(int4) + sizeof(int32_t)) +
         (size_t)chunk * (sizeof(int4) + sizeof(int32_t)) + tile;
}

// A pair's mask bits (bit k: candidate k evicted).
template <int kA>
struct MaskBits {
  using type = uint32_t;
};
template <>
struct MaskBits<64> {
  using type = uint64_t;
};

__device__ __forceinline__ uint32_t bit(uint32_t, int k) { return 1u << k; }
__device__ __forceinline__ uint64_t bit(uint64_t, int k) {
  return 1ull << k;
}
__device__ __forceinline__ int popcount(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int popcount(uint64_t x) { return __popcll(x); }

// Bytes 0/1 of four mask bits (bit k -> byte k): the nibble's bits land
// on bits 0, 8, 16 and 24 of the product without carries.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t bits) {
  return ((bits & 0xFu) * 0x00204081u) & 0x01010101u;
}

// One pair's mask, A bytes at `dst` (aligned to A, or to 16 past A = 16).
template <int kA>
__device__ __forceinline__ void store_mask(uint8_t* dst, uint64_t bits) {
  if constexpr (kA == 1) {
    *dst = (uint8_t)bits;
  } else if constexpr (kA == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        (uint16_t)nibble_bytes((uint32_t)bits);
  } else if constexpr (kA == 4) {
    *reinterpret_cast<uint32_t*>(dst) = nibble_bytes((uint32_t)bits);
  } else if constexpr (kA == 8) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(nibble_bytes((uint32_t)bits),
                   nibble_bytes((uint32_t)(bits >> 4)));
  } else {
#pragma unroll
    for (int q = 0; q < kA / 16; ++q) {
      const uint32_t b = (uint32_t)(bits >> (16 * q));
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(nibble_bytes(b), nibble_bytes(b >> 4),
                     nibble_bytes(b >> 8), nibble_bytes(b >> 12));
    }
  }
}

// The first j in 1..A with need <= C[j] (C[0] does not fit and the
// fitting j are an upper set), A + 1 when none.  At a power of two A the
// search is unrolled: C[A] first, then steps A/2, ..., 1 from the last j
// known not to fit.
template <int kA>
__device__ __forceinline__ int first_fit(const int4* cm, int4 need, int a) {
  if constexpr (kA != 0) {
    if (!le4(need, cm[kA])) return kA + 1;
    int pos = 0;                                   // C[pos] does not fit
#pragma unroll
    for (int step = kA / 2; step > 0; step /= 2) {
      if (!le4(need, cm[pos + step])) pos += step;
    }
    return pos + 1;
  } else {
    int lo = 1;
    int len = a;
    while (len > 0) {
      const int half = len >> 1;
      if (le4(need, cm[lo + half])) {
        len = half;
      } else {
        lo += half + 1;
        len -= half + 1;
      }
    }
    return lo;
  }
}

// kA: the alloc axis A, or 0 for the generic instantiation (A, T and
// whether the rows are staged from the arguments).
template <int kA>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    eviction_sets_kernel(EvictArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int A = kA ? kA : g.a;
  const int T = kA ? kWideTile : g.tile;
  const bool staged = kA ? true : g.staged != 0;
  const int S = row_stride(A);
  const int n0 = blockIdx.x * T;
  const int nv = min(T, g.n - n0);                 // valid nodes of the tile
  const int u0 = blockIdx.y * g.chunk;
  const int uc = min(g.chunk, g.u - u0);           // specs of the chunk

  // Shared memory, the 16-byte arrays first: asks, then per node its
  // sizes (k at t*S + k), its prefix sums (C[j] = sizes[0] + ... +
  // sizes[j - 1] at t*S + j, j = 0..A), job priorities, prio rows and a
  // flag a node.
  const size_t rows = staged ? (size_t)T * S : 0;
  int4* ask_s = reinterpret_cast<int4*>(smem);
  int4* sizes_s = ask_s + g.chunk;
  int4* cum_s = sizes_s + rows;
  int32_t* jp_s = reinterpret_cast<int32_t*>(cum_s + rows);
  int32_t* prio_s = jp_s + g.chunk;
  uint8_t* regular_s = reinterpret_cast<uint8_t*>(prio_s + rows);

  // Lanes over (node, spec): T nodes, 32 / T specs of a warp at a time.
  // The lane's node data is loaded first, to arrive during the staging.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane % T;
  const int group = 32 / T;
  const bool lane_valid = t < nv;
  const int n = n0 + (lane_valid ? t : 0);
  const int4 free = __ldg(g.free + n);
  const int4 used = __ldg(g.used + n);
  const float2 denom = __ldg(g.denom + n);

  // Stage: sizes and prio rows of the tile, the chunk's asks and job
  // priorities.  Each span is contiguous in global memory.
  if (staged) {
    const int4* sizes_g = g.sizes + (size_t)n0 * A;
    const int32_t* prio_g = g.prio + (size_t)n0 * A;
    for (int i = threadIdx.x; i < nv * A; i += kThreads) {
      const int node = i / A;
      const int k = i - node * A;
      sizes_s[node * S + k] = __ldg(sizes_g + i);
      prio_s[node * S + k] = __ldg(prio_g + i);
    }
  }
  for (int i = threadIdx.x; i < uc; i += kThreads) {
    ask_s[i] = __ldg(g.ask + u0 + i);
    jp_s[i] = __ldg(g.job_prio + u0 + i);
  }
  for (int i = threadIdx.x; i < nv; i += kThreads) regular_s[i] = staged;
  __syncthreads();

  // Once a node, four lanes a node (one a dimension): the prefix sums in
  // int32, as the reference sums them, and whether the node is regular --
  // the sums non-decreasing in every dimension from 0 and the priorities
  // non-decreasing.  A lane that finds otherwise clears the node's flag
  // (the writers agree).  Rows read in place are never regular.
  if (staged && threadIdx.x < 4 * nv) {
    const int node = threadIdx.x >> 2;
    const int d = threadIdx.x & 3;
    const int32_t* row = reinterpret_cast<const int32_t*>(sizes_s + node * S);
    int32_t* cum = reinterpret_cast<int32_t*>(cum_s + node * S);
    const int32_t* pr = prio_s + node * S;
    bool ok = true;
    int c = 0;
    int p_prev = INT32_MIN;
    cum[d] = 0;
#pragma unroll 4
    for (int k = 0; k < A; ++k) {
      const int c2 = c + row[4 * k + d];
      ok = ok && c <= c2;
      c = c2;
      cum[4 * (k + 1) + d] = c;
      if (d == 0) {
        const int p = pr[k];
        ok = ok && p_prev <= p;
        p_prev = p;
      }
    }
    if (!ok) regular_s[node] = 0;
  }
  __syncthreads();
  if (!lane_valid) return;                         // no barrier follows

  const int4* sz = staged ? sizes_s + t * S : g.sizes + (size_t)n * A;
  const int32_t* pr = staged ? prio_s + t * S : g.prio + (size_t)n * A;
  const int4* cm = cum_s + t * S;
  const bool regular = regular_s[t] != 0;
  const int4 zero = make_int4(0, 0, 0, 0);

  for (int ul = warp * group + lane / T; ul < uc; ul += kWarps * group) {
    const int4 ask = ask_s[ul];
    const int jp = jp_s[ul];
    const int4 need = sub4(ask, free);
    const bool fits0 = le4(need, zero);
    int kstar = 0;
    bool feasible = false;
    int4 freed = zero;
    if (regular) {
      // The fitting prefixes are an upper set: k* is the first j in
      // 1..A with need <= C[j] (A + 1 when none), by binary search, and
      // it is within the candidates iff candidate k* - 1 is below the
      // spec's priority (the priorities are sorted).
      if (!fits0) kstar = first_fit<kA>(cm, need, A);
      if (!fits0 && kstar <= A && pr[kstar - 1] < jp) {
        feasible = true;
        freed = cm[kstar];
      }
    } else {
      int fits = fits0 ? 1 : 0;
      int ncand = 0;
      int4 c = zero;
#pragma unroll 1
      for (int k = 0; k < A; ++k) {
        c = add4(c, sz[k]);
        fits += le4(need, c) ? 1 : 0;
        ncand += pr[k] < jp ? 1 : 0;
      }
      kstar = (A + 1) - fits;
      feasible = kstar >= 1 && kstar <= ncand;
      if (feasible) {
#pragma unroll 1
        for (int k = 0; k < kstar; ++k) freed = add4(freed, sz[k]);
      }
    }

    // Backward trim, from the last candidate of the prefix to the first
    // (on a regular node the last one stays: without it the prefix
    // k* - 1 would fit).
    const size_t cell = (size_t)(u0 + ul) * g.n + n;
    uint8_t* mask = g.mask + cell * A;
    int evict = 0;
    const int top = feasible ? (regular ? kstar - 2 : kstar - 1) : -1;
    if constexpr (kA != 0) {
      using Bits = typename MaskBits<kA>::type;
      Bits bits = (feasible && regular) ? bit(Bits(), kstar - 1) : Bits(0);
#pragma unroll 1
      for (int k = top; k >= 0; --k) {
        const int4 without = sub4(freed, sz[k]);
        const bool drop = le4(need, without);
        freed = drop ? without : freed;
        bits |= drop ? Bits(0) : bit(Bits(), k);
      }
      store_mask<kA>(mask, bits);
      evict = popcount(bits);
    } else {
#pragma unroll 1
      for (int k = A - 1; k >= 0; --k) {
        bool keep = false;
        if (k <= top) {
          const int4 without = sub4(freed, sz[k]);
          if (le4(need, without)) {
            freed = without;
          } else {
            keep = true;
          }
        } else {
          keep = feasible && regular && k == kstar - 1;
        }
        mask[k] = keep ? 1 : 0;
        evict += keep ? 1 : 0;
      }
    }

    // Post-eviction ScoreFit: used - freed + ask in int32, then the
    // shared ScoreFit with a zero ask.
    const int4 after = add4(sub4(used, freed), ask);
    nomad::Node nd;
    nd.free = zero;
    nd.used_cpu = (float)after.x;
    nd.used_mem = (float)after.y;
    nd.denom = denom;
    g.feasible[cell] = feasible ? 1 : 0;
    g.n_evict[cell] = evict;
    g.score[cell] = nomad::score_fit(nd, zero);
  }
}

using Kernel = void (*)(EvictArgs);

Kernel kernel_for(int a) {
  switch (a) {
    case 1: return eviction_sets_kernel<1>;
    case 2: return eviction_sets_kernel<2>;
    case 4: return eviction_sets_kernel<4>;
    case 8: return eviction_sets_kernel<8>;
    case 16: return eviction_sets_kernel<16>;
    case 32: return eviction_sets_kernel<32>;
    case 64: return eviction_sets_kernel<64>;
    default: return eviction_sets_kernel<0>;
  }
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on
// success).  Pointers are device pointers; free, used, sizes and ask must
// be 16-byte aligned, denom 8-byte (the wrapper checks), mask 16-byte (the
// wrapper allocates it).  Outputs: mask [u, n, a] and feasible [u, n] as
// bytes, n_evict [u, n] int32, score [u, n] float.  u <= 65535.
extern "C" int nomad_eviction_sets(const int32_t* free, const int32_t* used,
                                   const float* denom, const int32_t* prio,
                                   const int32_t* sizes, const int32_t* ask,
                                   const int32_t* job_prio, int u, int n,
                                   int a, uint8_t* mask, uint8_t* feasible,
                                   int32_t* n_evict, float* score,
                                   void* stream) {
  if (u <= 0 || n <= 0) return 0;
  if (u > 65535 || a <= 0) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(a);
  const bool templated = kernel != eviction_sets_kernel<0>;
  // The tile: 32 nodes, or fewer where the rows would not fit.
  int tile = kWideTile;
  bool staged = true;
  if (!templated) {
    while (tile > 1 && smem_bytes(tile, a, kWarps, true) > kSmemBudget)
      tile /= 2;
    staged = smem_bytes(tile, a, kWarps, true) <= kSmemBudget;
  }
  const long long tiles = (n + tile - 1) / tile;
  cudaError_t err = cudaSuccess;
  if (smem_bytes(tile, a, kMaxChunk, staged) > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBudget);
    if (err != cudaSuccess) return (int)err;
  }
  // Spec chunks: as many as leave the whole grid resident at once (one
  // round of blocks, so no block's staging waits for another's work), a
  // chunk at least a spec a warp and at most kMaxChunk specs and what
  // shared memory leaves for the asks.
  const int per_pass = kWarps * (32 / tile);
  const long long most = (u + per_pass - 1) / per_pass;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem_bytes(tile, a, per_pass, staged));
  if (err != cudaSuccess) return (int)err;
  long long chunks = (long long)nomad::sm_count() * (per_sm > 0 ? per_sm : 1) /
                     tiles;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  long long chunk = (u + chunks - 1) / chunks;
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  const long long room =
      (long long)(kSmemBudget - smem_bytes(tile, a, 0, staged)) /
      (long long)(sizeof(int4) + sizeof(int32_t));
  if (chunk > room) chunk = room;
  chunks = (u + chunk - 1) / chunk;

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
  g.tile = tile;
  g.chunk = (int)chunk;
  g.staged = staged ? 1 : 0;
  g.mask = mask;
  g.feasible = feasible;
  g.n_evict = n_evict;
  g.score = score;
  const size_t smem = smem_bytes(tile, a, (int)chunk, staged);
  const dim3 grid((unsigned)tiles, (unsigned)chunks);
  void* args[] = {&g};
  return (int)cudaLaunchKernel((const void*)kernel, grid, dim3(kThreads),
                               args, smem, (cudaStream_t)stream);
}
