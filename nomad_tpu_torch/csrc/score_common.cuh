// score_common.cuh: the per-(spec, node) fit test and ScoreFit shared by
// the port's score kernels (scored_rows.cu, masked_score.cu), so the
// expression exists once, as `_masked_fit_score` does for the two Pallas
// kernels it replaces (nomad_tpu/ops/pallas_score.py:44-60).
//
// Numerics, held against the plain PyTorch version (ops/fused_score.py
// score_fit):
// - FMA: every ScoreFit term uses __fadd_rn/__fsub_rn/__fdiv_rn, which
//   are never contracted, so each operation rounds on its own as in the
//   plain version and the jnp composition.
// - 10^x is powf(10.f, x), as PyTorch's CUDA pow computes it.  It need
//   not round like the CPU's pow; chip_smoke.py counts the differing
//   bits on the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nomad {

constexpr float kNegInf = -1e30f;

// ask <= cap - used on all four dimensions (kernels.py:463-466).
__device__ __forceinline__ bool fits(int4 used, int4 cap, int4 ask) {
  return ask.x <= cap.x - used.x && ask.y <= cap.y - used.y &&
         ask.z <= cap.z - used.z && ask.w <= cap.w - used.w;
}

// Google best-fit-v3 (funcs.go:123 ScoreFit) with the denom == 0 and
// NaN/inf rules of kernels.py:278-292:
//   clip(nan_to_num(20 - 10^(1 - (used+ask)/denom)_cpu - 10^(...)_mem),
//        0, 18)
__device__ __forceinline__ float score_fit(int4 used, int4 ask, float2 denom) {
  const float after_cpu = __fadd_rn((float)used.x, (float)ask.x);
  const float after_mem = __fadd_rn((float)used.y, (float)ask.y);
  const float safe_cpu = denom.x == 0.f ? 1.f : denom.x;
  const float safe_mem = denom.y == 0.f ? 1.f : denom.y;
  float frac_cpu = __fsub_rn(1.f, __fdiv_rn(after_cpu, safe_cpu));
  float frac_mem = __fsub_rn(1.f, __fdiv_rn(after_mem, safe_mem));
  if (denom.x == 0.f) frac_cpu = -INFINITY;
  if (denom.y == 0.f) frac_mem = -INFINITY;
  const float total = __fadd_rn(powf(10.f, frac_cpu), powf(10.f, frac_mem));
  float score = __fsub_rn(20.f, total);
  // nan_to_num(nan=0, posinf=18, neginf=0), then clip to [0, 18].
  if (isnan(score)) score = 0.f;
  else if (isinf(score)) score = score > 0.f ? 18.f : 0.f;
  return fminf(fmaxf(score, 0.f), 18.f);
}

}  // namespace nomad
