// masked_score: the shard-local candidate score of the node mesh, written
// by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nomad_tpu/ops/pallas_score.py
// (_score_kernel, entry masked_score_matrix), the mask+score of
// nomad_tpu/parallel/sharded.py:_local_topk_scores:
//
//   ok    = feas[u,n] && all_d(ask[u,d] <= cap[n,d] - used[n,d])
//   score = ok ? ScoreFit(used[n], ask[u], denom[n]) : -1e30
//
// with no penalty and no tie jitter (the candidate path ranks bare
// bin-pack scores; ties are broken later by node index).
//
// What bounds it on an H100: bytes.  Per (u, n) cell it reads feas (1 B)
// and writes the score (4 B); per node it reads used, cap (16 B each) and
// denom (8 B), which stay L2-resident across the rows of a node block
// (10 MB for a 250,016-node shard, inside the 50 MB L2).  One config_mesh
// shard (U = 128 x n_l = 250,016) must move 128 * 250,016 * 5 + 250,016
// * 40 B = 170 MB: >= 51 us at 3.35 TB/s; the four shards 680 MB, 0.2 ms.
// About 25 flops and two powf per cell against 5 bytes is under the
// card's ridge, so the bytes set the bound.
//
// Design (simple and right first): one thread per (u, n), grid = (node
// blocks, spec rows), nothing carried between blocks.  used/cap are read
// as one 16-byte int4 per node in the port's [N, 4] row layout --
// neighbouring threads read neighbouring rows, fully coalesced -- and
// feas as one byte per thread.  The TPU kernel's SoA transpose ([4, N])
// and its 512-node block padding existed for the TPU's lanes and are not
// carried over: the ragged edge is masked here.  Each row re-reads the
// node block's 40 B per node from L2; a thread looping over several rows
// would cut that traffic and is left to a later change.
//
// Numerics: the fit test and ScoreFit come from score_common.cuh, shared
// with scored_rows.cu, so this kernel's score equals scored_rows' `base`
// bit for bit wherever `ok` holds (chip_smoke.py checks it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) masked_score_kernel(
    const uint8_t* __restrict__ feas, const int4* __restrict__ used,
    const int4* __restrict__ cap, const float2* __restrict__ denom,
    const int4* __restrict__ ask, int n, float* __restrict__ out) {
  const int col = blockIdx.x * kBlock + threadIdx.x;
  if (col >= n) return;
  const int u = blockIdx.y;
  const size_t idx = (size_t)u * n + col;
  const int4 us = used[col];
  const int4 a = ask[u];
  const bool ok = feas[idx] != 0 && nomad::fits(us, cap[col], a);
  out[idx] = ok ? nomad::score_fit(us, a, denom[col]) : nomad::kNegInf;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; used/cap/ask must be 16-byte aligned and
// denom 8-byte aligned (the wrapper checks).  u <= 65535.
extern "C" int nomad_masked_score(const uint8_t* feas, const int32_t* used,
                                  const int32_t* cap, const float* denom,
                                  const int32_t* ask, int u, int n,
                                  float* out, void* stream) {
  if (u <= 0 || n <= 0) return 0;
  const dim3 grid((n + kBlock - 1) / kBlock, u);
  masked_score_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      feas, reinterpret_cast<const int4*>(used),
      reinterpret_cast<const int4*>(cap), reinterpret_cast<const float2*>(denom),
      reinterpret_cast<const int4*>(ask), n, out);
  return (int)cudaGetLastError();
}
