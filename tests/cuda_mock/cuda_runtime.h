// A CPU mock of the CUDA runtime, for compiling a kernel of
// nomad_tpu_torch/csrc with g++ and running it on host memory
// (tests/test_torch_round_source.py).  Only what the round kernel and
// score_common.cuh use.
//
// A launch runs every block of its grid at once, one std::thread a block,
// as a cooperative launch keeps every block resident.  Inside a block,
// each CUDA thread is a fiber (ucontext) that runs until it waits:
// __syncthreads waits for the block, a warp shuffle or __match_any_sync
// for its warp, and the grid barrier
// (cooperative_groups.h) for the block and then for every other block.
// Since a block is one OS thread, `__shared__` is `thread_local`: each
// block has its own static shared variables and its own dynamic shared
// array (nomad_round_smem, as large as the card allows a block).  Atomics
// take one mutex.  A block whose threads wait on each other, or a block
// that leaves the kernel while others wait at a grid barrier, aborts the
// process with a message: the card would hang.
//
// nomad_mock_device(sms, smem_optin, blocks_per_sm) sets what the device
// queries report; a cooperative launch of more blocks than the SMs hold,
// or with more dynamic shared memory than allowed, is refused as on the
// card.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <array>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <tuple>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ thread_local
#define __align__(n) __attribute__((aligned(n)))
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorCooperativeLaunchTooLarge = 82;
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount,
  cudaDevAttrMaxSharedMemoryPerBlockOptin
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes { size_t sharedSizeBytes; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct int4 { int x, y, z, w; };
struct float2 { float x, y; };
struct uchar4 { unsigned char x, y, z, w; };
struct float4 { float x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
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

// The card's opt-in shared memory a block (H100: 227 KB).
constexpr size_t kMockSmemMax = 232448;
// The round kernel's dynamic shared array: one for each block's thread.
__attribute__((aligned(16))) thread_local unsigned char nomad_round_smem[kMockSmemMax];

namespace mock {
struct Idx { unsigned x, y, z; };

// A barrier among fibers of one block: `members` arrivals end a
// generation.
struct Gate { int count = 0; int gen = 0; };

struct Fiber {
  ucontext_t ctx;
  Idx tidx{0, 0, 0};
  const int* wait_gen = nullptr;   // runnable again once *wait_gen != wait_val
  int wait_val = 0;
  bool done = false;
  std::unique_ptr<char[]> stack;
};

struct Block {
  Idx idx{0, 0, 0};
  int nthreads = 0;
  std::vector<Fiber> fibers;
  ucontext_t sched;
  Gate bar, grid_bar;
  std::vector<Gate> warp_gates;
  std::vector<std::array<long long, 32>> warp_vals;
  int or_flag = 0;
  std::function<void()> body;
};

inline thread_local Block* blk = nullptr;
inline thread_local Fiber* cur = nullptr;
inline Idx grid_dim{1, 1, 1};
inline int sms = 132;
inline int blocks_per_sm = 1;
inline size_t smem_optin = kMockSmemMax;
inline size_t func_dyn_smem = 48 * 1024;   // cudaFuncSetAttribute's value
inline std::mutex atom_mu;

// The grid barrier across the blocks' OS threads.
inline std::mutex grid_mu;
inline std::condition_variable grid_cv;
inline int grid_count = 0, grid_gen = 0, grid_blocks = 0, blocks_done = 0;

[[noreturn]] inline void fail(const char* what) {
  std::fprintf(stderr, "cuda mock: %s\n", what);
  std::fflush(stderr);
  std::abort();
}

// The current fiber waits at gate g until `members` fibers arrived.
inline void wait(Gate& g, int members) {
  const int gen = g.gen;
  if (++g.count == members) {
    g.count = 0;
    ++g.gen;
    return;
  }
  cur->wait_gen = &g.gen;
  cur->wait_val = gen;
  swapcontext(&cur->ctx, &blk->sched);
}

inline void grid_arrive_and_wait() {
  std::unique_lock<std::mutex> lk(grid_mu);
  const int gen = grid_gen;
  if (++grid_count == grid_blocks) {
    grid_count = 0;
    ++grid_gen;
    grid_cv.notify_all();
    return;
  }
  while (grid_gen == gen) {
    if (blocks_done > 0) fail("a block left the kernel while others wait at a grid barrier");
    grid_cv.wait_for(lk, std::chrono::milliseconds(200));
  }
}

// cooperative_groups::this_grid().sync(): the block's threads, then the
// blocks.
inline void grid_sync() {
  Gate& g = blk->grid_bar;
  const int gen = g.gen;
  if (++g.count == blk->nthreads) {
    grid_arrive_and_wait();
    g.count = 0;
    ++g.gen;
    return;
  }
  cur->wait_gen = &g.gen;
  cur->wait_val = gen;
  swapcontext(&cur->ctx, &blk->sched);
}

inline int lane() { return cur->tidx.x & 31; }

// Each lane posts v; f reads all 32 values after everyone posted.
template <class F> long long exchange(long long v, F f) {
  const int w = cur->tidx.x / 32;
  blk->warp_vals[w][lane()] = v;
  wait(blk->warp_gates[w], 32);
  const long long r = f(blk->warp_vals[w].data());
  wait(blk->warp_gates[w], 32);
  return r;
}

inline void fiber_main() {
  blk->body();
  cur->done = true;   // returns to the scheduler through uc_link
}

// Runs one block on this OS thread: a fiber a CUDA thread, each resumed
// in turn until it waits or ends.
inline void run_block(Block& b) {
  constexpr size_t kStack = 64 * 1024;
  blk = &b;
  b.fibers = std::vector<Fiber>(b.nthreads);
  b.warp_gates.assign(b.nthreads / 32, Gate{});
  b.warp_vals.assign(b.nthreads / 32, std::array<long long, 32>{});
  for (int t = 0; t < b.nthreads; ++t) {
    Fiber& f = b.fibers[t];
    f.tidx = {(unsigned)t, 0, 0};
    f.stack.reset(new char[kStack]);
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.get();
    f.ctx.uc_stack.ss_size = kStack;
    f.ctx.uc_link = &b.sched;
    makecontext(&f.ctx, fiber_main, 0);
  }
  int live = b.nthreads;
  while (live > 0) {
    bool ran = false;
    for (Fiber& f : b.fibers) {
      if (f.done || (f.wait_gen != nullptr && *f.wait_gen == f.wait_val)) continue;
      f.wait_gen = nullptr;
      cur = &f;
      ran = true;
      swapcontext(&b.sched, &f.ctx);
      if (f.done) --live;
    }
    if (!ran) fail("the threads of a block wait on each other");
  }
  std::lock_guard<std::mutex> lk(grid_mu);
  ++blocks_done;
  grid_cv.notify_all();
}
}  // namespace mock

#define threadIdx (mock::cur->tidx)
#define blockIdx (mock::blk->idx)
#define gridDim (mock::grid_dim)
#define blockDim (mock::Idx{(unsigned)mock::blk->nthreads, 1, 1})

// The device this mock reports: its SMs, the opt-in shared memory of a
// block, and the blocks of the kernel an SM holds (the card's defaults:
// 132, 227 KB, 1).
extern "C" void nomad_mock_device(int sms, long long smem_optin, int blocks_per_sm) {
  mock::sms = sms;
  mock::smem_optin = (size_t)smem_optin;
  mock::blocks_per_sm = blocks_per_sm;
}

inline void __syncthreads() { mock::wait(mock::blk->bar, mock::blk->nthreads); }
inline int __syncthreads_or(int p) {
  __syncthreads();
  if (p) mock::blk->or_flag = 1;
  __syncthreads();
  const int r = mock::blk->or_flag;
  __syncthreads();
  if (threadIdx.x == 0) mock::blk->or_flag = 0;
  __syncthreads();
  return r;
}
template <class T> T __shfl_sync(unsigned, T x, int src) {
  return (T)mock::exchange((long long)x, [src](long long* v) { return v[src & 31]; });
}
template <class T> T __shfl_up_sync(unsigned, T x, int d) {
  const int l = mock::lane();
  return (T)mock::exchange((long long)x, [l, d, x](long long* v) { return l - d >= 0 ? v[l - d] : (long long)x; });
}
template <class T> T __shfl_down_sync(unsigned, T x, int d) {
  const int l = mock::lane();
  return (T)mock::exchange((long long)x, [l, d, x](long long* v) { return l + d < 32 ? v[l + d] : (long long)x; });
}
template <class T> T __shfl_xor_sync(unsigned, T x, int m) {
  const int l = mock::lane();
  return (T)mock::exchange((long long)x, [l, m](long long* v) { return v[(l ^ m) & 31]; });
}
template <class T> unsigned __match_any_sync(unsigned, T x) {
  return (unsigned)mock::exchange((long long)x, [x](long long* v) {
    unsigned r = 0; for (int l = 0; l < 32; ++l) if (v[l] == (long long)x) r |= 1u << l; return (long long)r; });
}
inline int atomicAdd(int* p, int v) { std::lock_guard<std::mutex> g(mock::atom_mu); int o = *p; *p = o + v; return o; }
inline unsigned long long atomicMax(unsigned long long* p, unsigned long long v) { std::lock_guard<std::mutex> g(mock::atom_mu); unsigned long long o = *p; if (v > o) *p = v; return o; }

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? mock::sms : (int)mock::smem_optin;
  return cudaSuccess;
}
// The mock cannot see a kernel's static shared memory: 0.
template <class K> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* fa, K) {
  fa->sharedSizeBytes = 0;
  return cudaSuccess;
}
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int value) {
  if (value < 0 || (size_t)value > mock::smem_optin) return cudaErrorInvalidValue;
  mock::func_dyn_smem = (size_t)value;
  return cudaSuccess;
}
template <class K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int threads, size_t dyn) {
  *n = threads <= 1024 && dyn <= mock::smem_optin ? mock::blocks_per_sm : 0;
  return cudaSuccess;
}

// score_common.cuh's launcher of the score kernels; never called here.
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t) {
  return cudaErrorInvalidValue;
}

namespace mock {
// Runs the grid: every block on its own OS thread, all at once.
template <class... A, size_t... I>
void run_grid(void (*f)(A...), void** args, int threads, std::index_sequence<I...>) {
  std::tuple<A...> t{*static_cast<A*>(args[I])...};
  std::vector<Block> blocks(grid_dim.x);
  grid_count = grid_gen = blocks_done = 0;
  grid_blocks = (int)grid_dim.x;
  std::vector<std::thread> th;
  for (unsigned b = 0; b < grid_dim.x; ++b) {
    blocks[b].idx = {b, 0, 0};
    blocks[b].nthreads = threads;
    blocks[b].body = [&] { f(std::get<I>(t)...); };
    th.emplace_back([&blocks, b] { run_block(blocks[b]); });
  }
  for (auto& x : th) x.join();
}
}  // namespace mock

template <class... A>
cudaError_t cudaLaunchCooperativeKernel(void (*f)(A...), dim3 grid, dim3 block, void** args,
                                        size_t dyn, cudaStream_t) {
  if (block.x % 32 || block.x > 1024 || grid.x < 1 ||
      dyn > std::max(mock::func_dyn_smem, (size_t)48 * 1024) || dyn > kMockSmemMax)
    return cudaErrorInvalidValue;
  if (grid.x > (unsigned)(mock::sms * mock::blocks_per_sm)) return cudaErrorCooperativeLaunchTooLarge;
  mock::grid_dim = {grid.x, 1, 1};
  mock::run_grid(f, args, (int)block.x, std::index_sequence_for<A...>{});
  return cudaSuccess;
}
