// A CPU emulation of the CUDA features that csrc/beam_consensus.cu,
// csrc/anchors_topk.cu and csrc/retrieval_count.cu use, so that their
// sources compile with a host C++20 compiler and run in a test
// without a card: one std::thread per CUDA thread, the blocks of a launch
// one after another, each warp collective (shuffles, votes, reductions) a
// rendezvous of the warp's 32 threads and __syncthreads a barrier of the
// block.  A collective that not every lane of a warp reaches hangs here, as
// it may on the card.  Timing, memory spaces and the float rounding modes
// are not emulated (__fmul_rn / __fadd_rn are plain float operations with
// contraction off: compile with -ffp-contract=off).
//
// The kernel source needs two textual changes first (see
// tests/test_torch_kernels.py:emulated_source): its dynamic shared array
// becomes a pointer to the block's buffer and its launch a call of
// emu_launch.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __align__(x)

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 2,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 3
};

// The shared memory a block may use (an H100's); a test may lower it to
// reach a kernel's device-scratch route.
inline int emu_max_smem = 232448;

inline int cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline int cudaDeviceGetAttribute(int* v, int, int) {
  *v = emu_max_smem;
  return 0;
}
template <class F>
inline int cudaFuncSetAttribute(F, int, int) {
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "emulated"; }
template <class T>
inline int cudaMemcpyFromSymbol(void* dst, const T& sym, size_t n) {
  std::memcpy(dst, &sym, n);
  return 0;
}

struct alignas(8) int2 {
  int x, y;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(2) uchar2 {
  unsigned char x, y;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline int2 make_int2(int x, int y) { return {x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline uchar2 make_uchar2(unsigned char x, unsigned char y) { return {x, y}; }

struct EmuDim {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local EmuDim threadIdx, blockIdx;
inline EmuDim blockDim;

struct EmuWarp {
  std::barrier<> bar{32};
  long long v[32];
};
inline thread_local EmuWarp* emu_warp;
inline thread_local int emu_lane;
inline thread_local unsigned char* emu_smem;
inline thread_local std::barrier<>* emu_block_bar;

// Every lane posts x; all lanes see all 32 values.
inline void emu_exchange(long long x, long long* all) {
  EmuWarp& w = *emu_warp;
  w.v[emu_lane] = x;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 32; ++i) all[i] = w.v[i];
  w.bar.arrive_and_wait();
}
inline int emu_read_lane(int v, int src) {
  long long a[32];
  emu_exchange(v, a);
  return (int)a[src & 31];
}

inline int __shfl_sync(unsigned, int v, int src) {
  return emu_read_lane(v, src);
}
inline int __shfl_xor_sync(unsigned, int v, int m) {
  return emu_read_lane(v, emu_lane ^ m);
}
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int m) {
  return (unsigned)emu_read_lane((int)v, emu_lane ^ m);
}
inline int __shfl_up_sync(unsigned, int v, int d) {
  const int s = emu_lane - d;
  return emu_read_lane(v, s < 0 ? emu_lane : s);
}
inline int __shfl_down_sync(unsigned, int v, int d) {
  const int s = emu_lane + d;
  return emu_read_lane(v, s > 31 ? emu_lane : s);
}
inline int __reduce_min_sync(unsigned, int v) {
  long long a[32];
  emu_exchange(v, a);
  int m = (int)a[0];
  for (int i = 1; i < 32; ++i) m = std::min(m, (int)a[i]);
  return m;
}
inline int __reduce_add_sync(unsigned, int v) {
  long long a[32];
  emu_exchange(v, a);
  int m = 0;
  for (int i = 0; i < 32; ++i) m += (int)a[i];
  return m;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  long long a[32];
  emu_exchange(p ? 1 : 0, a);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (a[i]) m |= 1u << i;
  return m;
}
inline bool __any_sync(unsigned mask, bool p) {
  return __ballot_sync(mask, p) != 0;
}
// The lanes whose v equals this lane's.
inline unsigned __match_any_sync(unsigned, int v) {
  long long a[32];
  emu_exchange(v, a);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if ((int)a[i] == v) m |= 1u << i;
  return m;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp->bar.arrive_and_wait();
}
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
// Byte n of the result is byte (s >> 4 n) & 7 of the pair (y:x).
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long in = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned)((in >> (8 * ((s >> (4 * n)) & 7))) & 0xffu) << (8 * n);
  return r;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicOr(int* p, int v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicCAS(int* p, int cmp, int v) {
  __atomic_compare_exchange_n(p, &cmp, v, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return cmp;
}
inline unsigned short __ldg(const unsigned short* p) { return *p; }
inline long long clock64() { return 0; }

// kernel<<<grid, threads, smem>>>(p): the blocks one after another, each
// with its threads and a zeroed shared buffer of smem bytes.
template <class K, class P>
inline void emu_launch(K kernel, unsigned grid, unsigned threads, size_t smem,
                       P p) {
  blockDim.x = threads;
  for (unsigned b = 0; b < grid; ++b) {
    std::vector<unsigned char> sm(smem + 16, 0);
    std::barrier<> block_bar((std::ptrdiff_t)threads);
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (unsigned w = 0; w < threads / 32; ++w) warps.emplace_back(new EmuWarp);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_lane = (int)(t & 31);
        emu_warp = warps[t >> 5].get();
        emu_smem = sm.data();
        emu_block_bar = &block_bar;
        kernel(p);
      });
    for (auto& t : ts) t.join();
  }
}
