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
// Also writes `base` through an optional second pointer (null: not
// written): the placement loop records it as the commit's AllocMetric
// binpack score when it keeps scores, so it is not computed twice.
//
// What bounds it on an H100.  Bytes at the loop's call: per (u, n) cell
// feas (1 B) and coll (4 B) in, scored (4 B) and base (4 B, when asked)
// out; per node used, cap (16 B each) and denom (8 B).  At U = 1 over one
// config_mesh shard (250,016 nodes) that is 13.3 MB with base and 12.3 MB
// without: 4.0 and 3.7 us at 3.35 TB/s.  At U = 1 x 10,112 (config (b))
// the call moves half a megabyte, so the launch and one DRAM round trip
// set the pace; at U = 128 the two powf and two divides of every cell
// (the issue rate) do.
//
// Design (score_common.cuh): the shared score tile.  A fixed grid of
// 256-thread blocks would give U = 1 x 10,112 40 blocks, so 40 of the 132
// SMs would hold all the work, and one thread per (u, n) re-reads node
// data for every row at U = 128.  The grid is instead planned from N, U
// and the SM count: 64-thread blocks of one node per thread at small N
// (158 blocks on 10,112 nodes), 128-thread blocks of one node per thread
// at U = 1 and large N (the mesh's shard call), and at U > 1 four nodes
// per thread with 16-byte feas/coll/scored/base accesses, node data in
// registers across a tile of up to 8 spec rows and the next row's inputs
// loaded while this row is computed.
//
// Numerics (score_common.cuh): `base - penalty*coll` and `+ jitter` use
// __fmul_rn/__fsub_rn/__fadd_rn, never contracted into an FMA, so each
// product is rounded on its own as in the plain version and the jnp
// composition; the jitter hash (fmix32) is native uint32 arithmetic on
// the global (u_offset + u, n_offset + n); the loop's ok also has
// distinct_hosts (kernels.py:467), which the caller ANDs into `feas`.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

namespace {

template <int V, nomad::Out kOut>
__global__ void __launch_bounds__(nomad::kWide)
    scored_rows_kernel(nomad::TileArgs a) {
  nomad::score_tile<V, kOut>(a);
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on
// success).  Pointers are device pointers; used/cap/ask must be 16-byte
// aligned and denom 8-byte aligned (the wrapper checks); feas, coll, out
// and base_out need only their element's alignment (the vector path is
// taken where they allow it).  base_out may be null.  u <= 65535.
extern "C" int nomad_scored_rows(const uint8_t* feas, const int32_t* used,
                                 const int32_t* cap, const float* denom,
                                 const int32_t* ask, const float* penalty,
                                 const int32_t* coll, uint32_t seed,
                                 uint32_t u_offset, uint32_t n_offset, int u,
                                 int n, float* out, float* base_out,
                                 void* stream) {
  if (u <= 0 || n <= 0) return 0;
  using nomad::Out;
  nomad::TileArgs a = {};
  a.feas = feas;
  a.used = reinterpret_cast<const int4*>(used);
  a.cap = reinterpret_cast<const int4*>(cap);
  a.denom = reinterpret_cast<const float2*>(denom);
  a.ask = reinterpret_cast<const int4*>(ask);
  a.penalty = penalty;
  a.coll = coll;
  a.seed = seed;
  a.u_offset = u_offset;
  a.n_offset = n_offset;
  a.u = u;
  a.n = n;
  a.out = out;
  a.base = base_out;
  const cudaError_t err =
      base_out != nullptr
          ? nomad::launch(a, scored_rows_kernel<1, Out::kScoredBase>,
                          scored_rows_kernel<4, Out::kScoredBase>,
                          (cudaStream_t)stream)
          : nomad::launch(a, scored_rows_kernel<1, Out::kScored>,
                          scored_rows_kernel<4, Out::kScored>,
                          (cudaStream_t)stream);
  return (int)err;
}
