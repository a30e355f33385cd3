// score_common.cuh: the score-tile body shared by the port's two score
// kernels (scored_rows.cu, masked_score.cu), with its fit test, ScoreFit,
// tie jitter and launch plan, so the expression exists once, as
// `_masked_fit_score` does for the two Pallas kernels they replace
// (nomad_tpu/ops/pallas_score.py:44-60).
//
// The tile.  A thread owns V consecutive nodes (V = 4 on the vector path,
// 1 on the scalar path) and a block a tile of R consecutive spec rows.
// The thread loads its nodes' used, cap (one int4 each) and denom (float2)
// once, keeps what every row needs of them in registers (cap - used, used
// as floats, denom: 8 registers a node), then loops over the R rows: per
// row it reads the row's ask (and penalty) as uniform loads -- every
// thread of the warp asks for the same address, served once -- and its V
// cells of feas (one uchar4), coll (one int4) and writes scored/base/out
// (one float4 each).  Node data is read once per R rows instead of once a
// row.  Registers, not shared memory, hold it: no thread reads another
// thread's nodes, so staging them in shared memory (TMA or cp.async.bulk)
// would only add a copy and a barrier.
//
// The plan (launch, below) sizes the grid from N, U and the SM count:
// - V = 4 when N % 4 == 0, the per-cell pointers are 16-byte aligned
//   (feas 4-byte), U > 1 and the vector threads fill a wide block per SM;
//   every other shape takes V = 1, which has no ragged tail and no
//   alignment need beyond the element's.  At U = 1 node data is most of
//   the bytes (40 of 53 a node) and is read once: one node per thread
//   reads it fully coalesced, where four would read it at a 64-byte
//   stride.
// - Blocks of 64 threads when the work is too small to give every SM a
//   block of 128 (U = 1 x 10,112: 158 blocks of one node per thread, so
//   the call is one short dependent chain on every SM, not 40 long ones).
// - R = 8 rows per block, or fewer where 8 would leave the grid short of
//   one wave of resident blocks (the occupancy of the chosen kernel).  A
//   large U then reads node data U / 8 times, not U times, and the grid
//   is many short blocks that the card balances over its SMs: at U = 128
//   x 250,016, blocks of 64 rows that fill one wave exactly ran 20 %
//   slower on an H100 (chip_smoke.py --against; PERF.md).
//
// Numerics, held against the plain PyTorch version (ops/fused_score.py),
// bit for bit:
// - FMA: every ScoreFit, penalty and jitter term uses __fadd_rn/__fsub_rn/
//   __fmul_rn/__fdiv_rn, which are never contracted, so each operation
//   rounds on its own as in the plain version and the jnp composition.
// - 10^x is powf(10.f, x), as PyTorch's CUDA pow computes it (no fast
//   math, no exp2f rewrite).  It need not round like the CPU's pow;
//   chip_smoke.py counts the differing bits on the card.
// - cap - used and (float)used are computed once a node, outside the row
//   loop: the same integer and conversion results as inside it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nomad {

constexpr float kNegInf = -1e30f;
// float32(1e-3 / 2^24), rounded once from the double as the reference does.
constexpr float kJitterScale = (float)(1e-3 / 16777216.0);
constexpr int kThin = 64;    // threads of a block when the work is small
constexpr int kWide = 128;   // threads of a block otherwise
constexpr int kMaxRows = 8;  // spec rows of a block's tile, at most

// What the score kernels write: the masked ScoreFit; the commit score; or
// the commit score and its ScoreFit `base`.
enum class Out { kMasked, kScored, kScoredBase };

// The arguments of both kernels (coll, penalty, seed and the offsets are
// read by the commit score only; base by kScoredBase only).
struct TileArgs {
  const uint8_t* feas;
  const int4* used;
  const int4* cap;
  const float2* denom;
  const int4* ask;
  const float* penalty;
  const int32_t* coll;
  uint32_t seed, u_offset, n_offset;
  int u, n;
  int rows;    // R: spec rows of one block's tile
  float* out;
  float* base;
};

// One node's share of every cell in its column.
struct Node {
  int4 free;            // cap - used
  float used_cpu, used_mem;
  float2 denom;
};

__device__ __forceinline__ Node load_node(const TileArgs& a, int i) {
  const int4 us = __ldg(a.used + i);
  const int4 cp = __ldg(a.cap + i);
  Node nd;
  nd.free = make_int4(cp.x - us.x, cp.y - us.y, cp.z - us.z, cp.w - us.w);
  nd.used_cpu = (float)us.x;
  nd.used_mem = (float)us.y;
  nd.denom = __ldg(a.denom + i);
  return nd;
}

// ask <= cap - used on all four dimensions (kernels.py:463-466).
__device__ __forceinline__ bool fits(const Node& nd, int4 ask) {
  return ask.x <= nd.free.x && ask.y <= nd.free.y && ask.z <= nd.free.z &&
         ask.w <= nd.free.w;
}

// Google best-fit-v3 (funcs.go:123 ScoreFit) with the denom == 0 and
// NaN/inf rules of kernels.py:278-292:
//   clip(nan_to_num(20 - 10^(1 - (used+ask)/denom)_cpu - 10^(...)_mem),
//        0, 18)
__device__ __forceinline__ float score_fit(const Node& nd, int4 ask) {
  const float after_cpu = __fadd_rn(nd.used_cpu, (float)ask.x);
  const float after_mem = __fadd_rn(nd.used_mem, (float)ask.y);
  const float safe_cpu = nd.denom.x == 0.f ? 1.f : nd.denom.x;
  const float safe_mem = nd.denom.y == 0.f ? 1.f : nd.denom.y;
  float frac_cpu = __fsub_rn(1.f, __fdiv_rn(after_cpu, safe_cpu));
  float frac_mem = __fsub_rn(1.f, __fdiv_rn(after_mem, safe_mem));
  if (nd.denom.x == 0.f) frac_cpu = -INFINITY;
  if (nd.denom.y == 0.f) frac_mem = -INFINITY;
  const float total = __fadd_rn(powf(10.f, frac_cpu), powf(10.f, frac_mem));
  // nan_to_num(nan=0, posinf=18, neginf=0), then clip to [0, 18]: fmaxf
  // returns 0 for a NaN score and clips -inf to 0, fminf clips +inf to
  // 18, so the clip alone gives every bit of the two steps.
  return fminf(fmaxf(__fsub_rn(20.f, total), 0.f), 18.f);
}

// fmix32 of (seed, u, n) scaled into [0, 1e-3) (kernels.py:98-121), in
// native uint32 arithmetic.
__device__ __forceinline__ float tie_jitter(uint32_t seed, uint32_t u,
                                            uint32_t n) {
  uint32_t x = n * 0x9E3779B9u + u * 0x85EBCA6Bu + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return __fmul_rn((float)(x >> 8), kJitterScale);
}

// V cells of one row: 16-byte accesses at V = 4, scalar at V = 1.  Loads
// return the raw words; cell v is taken out where it is used, so a row
// loaded ahead is not waited for until then.
template <int V>
struct Cells;

template <>
struct Cells<1> {
  using Feas = uint8_t;
  using Coll = int;
  __device__ static Feas load_feas(const uint8_t* p) { return __ldg(p); }
  __device__ static Coll load_coll(const int32_t* p) { return __ldg(p); }
  __device__ static bool feas(Feas f, int) { return f != 0; }
  __device__ static int coll(Coll c, int) { return c; }
  __device__ static void store(float* p, const float (&x)[1]) { *p = x[0]; }
};

template <>
struct Cells<4> {
  using Feas = uchar4;
  using Coll = int4;
  __device__ static Feas load_feas(const uint8_t* p) {
    return __ldg(reinterpret_cast<const uchar4*>(p));
  }
  __device__ static Coll load_coll(const int32_t* p) {
    return __ldg(reinterpret_cast<const int4*>(p));
  }
  __device__ static bool feas(Feas f, int v) {
    return (v == 0 ? f.x : v == 1 ? f.y : v == 2 ? f.z : f.w) != 0;
  }
  __device__ static int coll(Coll c, int v) {
    return v == 0 ? c.x : v == 1 ? c.y : v == 2 ? c.z : c.w;
  }
  __device__ static void store(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

// One row's inputs of a thread's V cells (penalty and coll: the commit
// score only).
template <int V>
struct Row {
  int4 ask;
  float penalty;
  typename Cells<V>::Feas feas;
  typename Cells<V>::Coll coll;
};

template <int V, Out kOut>
__device__ __forceinline__ Row<V> load_row(const TileArgs& a, int u,
                                           int col) {
  const size_t idx = (size_t)u * a.n + col;
  Row<V> r;
  r.ask = __ldg(a.ask + u);
  r.feas = Cells<V>::load_feas(a.feas + idx);
  if constexpr (kOut != Out::kMasked) {
    r.penalty = __ldg(a.penalty + u);
    r.coll = Cells<V>::load_coll(a.coll + idx);
  }
  return r;
}

// One thread's V nodes over its block's R rows:
//   ok     = feas[u,n] && fits
//   base   = ScoreFit(used[n], ask[u], denom[n])
//   kMasked: out = ok ? base : -1e30
//   kScored: out = ok ? base - penalty[u]*coll[u,n] + jitter(u0+u, n0+n)
//                     : -1e30
template <int V, Out kOut>
__device__ __forceinline__ void score_tile(const TileArgs& a) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= a.n) return;
  Node nd[V];
#pragma unroll
  for (int v = 0; v < V; ++v) nd[v] = load_node(a, col + v);
  // Every block has at least one row (grid.y = ceil(U / R)).  The next
  // row's inputs are loaded before this row's cells are computed, so a
  // thread waits for memory once per tile, not once per row.
  const int u_begin = blockIdx.y * a.rows;
  const int u_end = min(a.u, u_begin + a.rows);
  Row<V> next = load_row<V, kOut>(a, u_begin, col);
  for (int u = u_begin; u < u_end; ++u) {
    const Row<V> row = next;
    if (u + 1 < u_end) next = load_row<V, kOut>(a, u + 1, col);
    float out[V], base[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool ok = Cells<V>::feas(row.feas, v) && fits(nd[v], row.ask);
      base[v] = score_fit(nd[v], row.ask);
      if constexpr (kOut == Out::kMasked) {
        out[v] = ok ? base[v] : kNegInf;
      } else {
        float score =
            __fsub_rn(base[v], __fmul_rn(row.penalty,
                                         (float)Cells<V>::coll(row.coll, v)));
        score = __fadd_rn(score, tie_jitter(a.seed, a.u_offset + (uint32_t)u,
                                            a.n_offset + (uint32_t)(col + v)));
        out[v] = ok ? score : kNegInf;
      }
    }
    const size_t idx = (size_t)u * a.n + col;
    Cells<V>::store(a.out + idx, out);
    if constexpr (kOut == Out::kScoredBase) Cells<V>::store(a.base + idx, base);
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// The card's SM count, read once a process: the cards one process drives
// are of one model.
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

using Kernel = void (*)(TileArgs);

// Plans the grid (see the note at the top) and launches `k1` (V = 1) or
// `k4` (V = 4) on `stream`; returns the launch's error (0 on success).
inline cudaError_t launch(TileArgs a, Kernel k1, Kernel k4,
                          cudaStream_t stream) {
  const long long sms = sm_count();
  const bool vec = a.n % 4 == 0 && aligned(a.feas, 4) && aligned(a.out, 16) &&
                   (a.coll == nullptr || aligned(a.coll, 16)) &&
                   (a.base == nullptr || aligned(a.base, 16));
  const bool v4 = vec && a.u > 1 && (long long)a.u * (a.n / 4) >= sms * kWide;
  const long long node_threads = v4 ? a.n / 4 : a.n;
  const int threads =
      (long long)a.u * node_threads >= sms * kWide ? kWide : kThin;
  const Kernel kernel = v4 ? k4 : k1;
  const int blocks_x = (int)((node_threads + threads - 1) / threads);
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  const long long wave = sms * (per_sm > 0 ? per_sm : 1);
  long long groups = wave / blocks_x;   // row tiles that fill one wave
  groups = groups < 1 ? 1 : (groups > a.u ? a.u : groups);
  a.rows = (int)((a.u + groups - 1) / groups);
  if (a.rows > kMaxRows) a.rows = kMaxRows;
  const dim3 grid(blocks_x, (a.u + a.rows - 1) / a.rows);
  void* args[] = {&a};
  return cudaLaunchKernel((const void*)kernel, grid, dim3(threads), args, 0,
                          stream);
}

}  // namespace nomad
