// scored_rows: the per-commit score of the placement loop, written by hand
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nomad_tpu/ops/pallas_score.py
// (_scored_row_kernel, entry scored_rows), which computes the commit-time
// scoring expression of nomad_tpu/ops/kernels.py:463-506:
//
//   ok     = feas[u,n] && all_d(ask[u,d] <= cap[n,d] - used[n,d])
//   base   = ScoreFit(used[n], ask[u], denom[n])       (funcs.go:123)
//   scored = ok ? base - penalty[u]*coll[u,n] + jitter(seed, u0+u, n0+n)
//               : -1e30
//
// Also writes `base` through an optional second pointer: the placement
// loop records it as the commit's AllocMetric binpack score, so it is not
// computed twice.
//
// What bounds it on an H100: bytes.  Per (u, n) cell it reads feas (1 B)
// and coll (4 B) and writes scored and base (8 B); per node it reads
// used, cap (16 B each) and denom (8 B) once.  About 20 flops and two
// powf per cell against ~13-53 bytes is far below the card's ~20 flop/B
// ridge, and at U = 1 (the loop's call, N ~ 10^4) the whole call moves
// ~0.5 MB: under 1 us at 3.35 TB/s, so the launch sets the pace.
//
// Design: one thread per (u, n), grid = (node blocks, spec rows), nothing
// carried between blocks.  used/cap stay in the port's [N, 4] int32 row
// layout and are read as one 16-byte int4 per node -- neighbouring
// threads read neighbouring 16-byte rows, fully coalesced.  The TPU
// kernel's SoA transpose ([4, N]) existed for the TPU's lane layout and
// is not carried over.
//
// Numerics, held against the plain PyTorch version (ops/fused_score.py):
// - The `ok` mask: the loop's ok also has distinct_hosts
//   (kernels.py:467); the caller ANDs that into `feas`, and the fit test
//   (score_common.cuh) repeats kernels.py:463-466 exactly.
// - ScoreFit comes from score_common.cuh, shared with masked_score.cu.
// - FMA: `base - penalty*coll` and `+ jitter` use __fmul_rn/__fsub_rn/
//   __fadd_rn, which are never contracted into an FMA, so each product is
//   rounded on its own as in the plain version and the jnp composition.
// - The jitter hash (fmix32) is native uint32 arithmetic here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

namespace {

using nomad::kNegInf;
// float32(1e-3 / 2^24), rounded once from the double as the reference does.
constexpr float kJitterScale = (float)(1e-3 / 16777216.0);
constexpr int kBlock = 256;

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

__global__ void __launch_bounds__(kBlock) scored_rows_kernel(
    const uint8_t* __restrict__ feas, const int4* __restrict__ used,
    const int4* __restrict__ cap, const float2* __restrict__ denom,
    const int4* __restrict__ ask, const float* __restrict__ penalty,
    const int32_t* __restrict__ coll, uint32_t seed, uint32_t u_offset,
    uint32_t n_offset, int n, float* __restrict__ out,
    float* __restrict__ base_out) {
  const int col = blockIdx.x * kBlock + threadIdx.x;
  if (col >= n) return;
  const int u = blockIdx.y;
  const size_t idx = (size_t)u * n + col;
  const int4 us = used[col];
  const int4 cp = cap[col];
  const int4 a = ask[u];
  const bool ok = feas[idx] != 0 && nomad::fits(us, cp, a);
  const float base = nomad::score_fit(us, a, denom[col]);
  float score = __fsub_rn(base, __fmul_rn(penalty[u], (float)coll[idx]));
  score = __fadd_rn(score, tie_jitter(seed, u_offset + (uint32_t)u,
                                      n_offset + (uint32_t)col));
  out[idx] = ok ? score : kNegInf;
  if (base_out != nullptr) base_out[idx] = base;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; used/cap/ask must be 16-byte aligned and
// denom 8-byte aligned (the wrapper checks).  u <= 65535.
extern "C" int nomad_scored_rows(const uint8_t* feas, const int32_t* used,
                                 const int32_t* cap, const float* denom,
                                 const int32_t* ask, const float* penalty,
                                 const int32_t* coll, uint32_t seed,
                                 uint32_t u_offset, uint32_t n_offset, int u,
                                 int n, float* out, float* base_out,
                                 void* stream) {
  if (u <= 0 || n <= 0) return 0;
  const dim3 grid((n + kBlock - 1) / kBlock, u);
  scored_rows_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      feas, reinterpret_cast<const int4*>(used),
      reinterpret_cast<const int4*>(cap), reinterpret_cast<const float2*>(denom),
      reinterpret_cast<const int4*>(ask), penalty, coll, seed, u_offset,
      n_offset, n, out, base_out);
  return (int)cudaGetLastError();
}
