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
// What bounds it on an H100.  Bytes: per (u, n) cell it reads feas (1 B)
// and writes the score (4 B); per node used, cap (16 B each) and denom
// (8 B).  One config_mesh shard (U = 128 x n_l = 250,016) must move
// 128 * 250,016 * 5 + 250,016 * 40 B = 170 MB: >= 51 us at 3.35 TB/s.
// And the issue rate: two powf and two IEEE divides make each cell some
// hundred instructions against 5 bytes, so at 32M cells the instruction
// stream (chip_smoke.py counts it in the SASS) sits at or above the
// byte bound.
//
// Design (score_common.cuh): the shared score tile.  One thread per
// (u, n) would re-read the node's 40 B from L2 for every one of the 128
// rows (1.28 GB of L2 traffic on top of the 170 MB).  Here a thread holds
// four nodes in registers across a tile of R = 8 rows (node data read 16
// times, not 128), loads feas as one uchar4 and stores one float4 per
// row, loading the next row's feas while it computes this one.  What is
// left is the instruction stream of the two powf and two divides per
// cell, which the numerics keep (same powf, same __fdiv_rn).
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

namespace {

template <int V>
__global__ void __launch_bounds__(nomad::kWide)
    masked_score_kernel(nomad::TileArgs a) {
  nomad::score_tile<V, nomad::Out::kMasked>(a);
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on
// success).  Pointers are device pointers; used/cap/ask must be 16-byte
// aligned and denom 8-byte aligned (the wrapper checks); feas and out
// need only their element's alignment (the vector path is taken where
// they allow it).  u <= 65535.
extern "C" int nomad_masked_score(const uint8_t* feas, const int32_t* used,
                                  const int32_t* cap, const float* denom,
                                  const int32_t* ask, int u, int n,
                                  float* out, void* stream) {
  if (u <= 0 || n <= 0) return 0;
  nomad::TileArgs a = {};
  a.feas = feas;
  a.used = reinterpret_cast<const int4*>(used);
  a.cap = reinterpret_cast<const int4*>(cap);
  a.denom = reinterpret_cast<const float2*>(denom);
  a.ask = reinterpret_cast<const int4*>(ask);
  a.u = u;
  a.n = n;
  a.out = out;
  return (int)nomad::launch(a, masked_score_kernel<1>, masked_score_kernel<4>,
                            (cudaStream_t)stream);
}
