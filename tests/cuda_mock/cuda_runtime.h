// A CPU mock of the CUDA runtime, for compiling a kernel of
// nomad_tpu_torch/csrc with g++ and running it on host memory
// (tests/test_torch_round_source.py).  One launch runs one block: one
// std::thread per CUDA thread, __syncthreads a std::barrier over the
// block, the warp shuffles, ballots and __match_any_sync an exchange
// through a per-warp barrier, __shared__ variables static, atomics under
// one mutex.  Only what the round kernel and score_common.cuh use.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#include <algorithm>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct int4 { int x, y, z, w; };
struct float2 { float x, y; };
struct uchar4 { unsigned char x, y, z, w; };
struct float4 { float x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
template <class T> void __stcg(T* p, T v) { *p = v; }

namespace mock {
struct Idx { unsigned x, y, z; };
inline thread_local Idx tidx{0, 0, 0};
inline int nthreads = 0;
inline std::barrier<>* block_bar = nullptr;
struct Warp { std::barrier<>* bar; long long vals[32]; };
inline std::vector<Warp> warps;
inline std::mutex atom_mu;
inline std::atomic<int> or_flag{0};
inline Warp& my_warp() { return warps[tidx.x / 32]; }
inline int lane() { return tidx.x & 31; }
// Each lane posts v; returns all 32 values (after everyone posted).
template <class F> long long exchange(long long v, F f) {
  Warp& w = my_warp();
  w.vals[lane()] = v;
  w.bar->arrive_and_wait();
  long long r = f(w.vals);
  w.bar->arrive_and_wait();
  return r;
}
}  // namespace mock
#define threadIdx (mock::tidx)
#define blockIdx (mock::Idx{0, 0, 0})
#define blockDim (mock::Idx{(unsigned)mock::nthreads, 1, 1})

inline void __syncthreads() { mock::block_bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  __syncthreads();
  if (p) mock::or_flag = 1;
  __syncthreads();
  int r = mock::or_flag;
  __syncthreads();
  if (threadIdx.x == 0) mock::or_flag = 0;
  __syncthreads();
  return r;
}
inline unsigned __ballot_sync(unsigned, int p) {
  return (unsigned)mock::exchange(p != 0, [](long long* v) {
    unsigned r = 0; for (int l = 0; l < 32; ++l) if (v[l]) r |= 1u << l; return (long long)r; });
}
template <class T> T __shfl_sync(unsigned, T x, int src) {
  return (T)mock::exchange((long long)x, [src](long long* v) { return v[src & 31]; });
}
template <class T> T __shfl_up_sync(unsigned, T x, int d) {
  int l = mock::lane();
  return (T)mock::exchange((long long)x, [l, d, x](long long* v) { return l - d >= 0 ? v[l - d] : (long long)x; });
}
template <class T> T __shfl_down_sync(unsigned, T x, int d) {
  int l = mock::lane();
  return (T)mock::exchange((long long)x, [l, d, x](long long* v) { return l + d < 32 ? v[l + d] : (long long)x; });
}
template <class T> unsigned __match_any_sync(unsigned, T x) {
  return (unsigned)mock::exchange((long long)x, [x](long long* v) {
    unsigned r = 0; for (int l = 0; l < 32; ++l) if (v[l] == (long long)x) r |= 1u << l; return (long long)r; });
}
inline int atomicAdd(int* p, int v) { std::lock_guard<std::mutex> g(mock::atom_mu); int o = *p; *p = o + v; return o; }
inline unsigned atomicMax(unsigned* p, unsigned v) { std::lock_guard<std::mutex> g(mock::atom_mu); unsigned o = *p; if (v > o) *p = v; return o; }
inline int atomicMin(int* p, int v) { std::lock_guard<std::mutex> g(mock::atom_mu); int o = *p; if (v < o) *p = v; return o; }

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 1; return 0; }
template <class K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t) { return 1; }
template <class A> cudaError_t cudaLaunchKernel(void (*f)(A), dim3 grid, dim3 block, void** args, size_t, cudaStream_t) {
  if (grid.x != 1 || block.x % 32) return 9;
  const int n = (int)block.x;
  std::barrier<> bb(n);
  mock::block_bar = &bb;
  mock::nthreads = n;
  std::vector<std::unique_ptr<std::barrier<>>> wb;
  mock::warps.assign(n / 32, mock::Warp{});
  for (int w = 0; w < n / 32; ++w) { wb.emplace_back(new std::barrier<>(32)); mock::warps[w].bar = wb.back().get(); }
  A a = *static_cast<A*>(args[0]);
  std::vector<std::thread> th;
  for (int t = 0; t < n; ++t) th.emplace_back([&, t] { mock::tidx = {(unsigned)t, 0, 0}; f(a); });
  for (auto& x : th) x.join();
  return 0;
}
