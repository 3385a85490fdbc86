// Warp-level stand-ins for tests/cuda_emu.h, for the int8 conv
// (lama_tpu_torch/csrc/conv_int8.cu; tests/test_torch_int8_emulated.py):
// __shfl_xor_sync, a two-dimensional grid, a barrier per warp and per
// warpgroup, and the few intrinsics and types that source uses beyond
// cuda_emu.h's (its wgmma stand-ins are tests/cuda_emu_wgmma.h). The 32
// threads of a warp meet at a barrier of their own; a collective writes
// each lane's operands to a per-warp slot, waits, computes its own lane's
// result from every lane's operands, and waits again before the slot is
// reused.
#pragma once
#include "cuda_emu.h"
#include <memory>
#include <mutex>

#define __align__(n) alignas(n)
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }
inline float __bfloat162float(__nv_bfloat16 b) {
  unsigned u = unsigned(b.v) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __int2float_rn(int i) { return float(i); }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

enum { cudaErrorLaunchOutOfResources = 7 };
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}

inline std::mutex emu_atomic_lock;
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> g(emu_atomic_lock);
  const unsigned old = *p;
  if (v > old) *p = v;
  return old;
}

constexpr int EMU_MAX_WARPS = 32;
struct EmuWarp {
  std::unique_ptr<std::barrier<>> bar;
  uint32_t slot[32][8];
};
inline EmuWarp emu_warps[EMU_MAX_WARPS];
inline int emu_lane() { return threadIdx.x % 32; }
inline EmuWarp& emu_warp() { return emu_warps[threadIdx.x / 32]; }
// the four warps of a warpgroup (a block of a multiple of 128 threads)
inline std::unique_ptr<std::barrier<>> emu_warpgroups[EMU_MAX_WARPS / 4];
inline void emu_warpgroup_sync() {
  if (!emu_warpgroups[threadIdx.x / 128]) emu_fail("no warpgroup barrier");
  emu_warpgroups[threadIdx.x / 128]->arrive_and_wait();
}
inline size_t emu_smem_bytes = 0;

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  EmuWarp& w = emu_warp();
  const int lane = emu_lane();
  memcpy(&w.slot[lane][0], &v, 4);
  w.bar->arrive_and_wait();
  float r;
  memcpy(&r, &w.slot[lane ^ mask][0], 4);
  w.bar->arrive_and_wait();
  return r;
}

// a launch over a 2-D grid: blocks one after another, each block's threads
// std::threads with a barrier per warp besides the block's
template <typename K, typename... A>
void emu_launch2(K kernel, dim3 grid, int threads, int smem, cudaStream_t,
                 A... args) {
  if (threads % 32 || threads / 32 > EMU_MAX_WARPS) emu_fail("block size");
  std::vector<unsigned char> buf(smem > 0 ? smem : 1);
  emu_smem = buf.data();
  emu_smem_bytes = smem > 0 ? size_t(smem) : 0;
  gridDim = {int(grid.x), int(grid.y), 1};
  for (int i = 0; i < threads / 32; ++i)
    emu_warps[i].bar = std::make_unique<std::barrier<>>(32);
  for (int i = 0; i < EMU_MAX_WARPS / 4; ++i)
    emu_warpgroups[i].reset(threads % 128 == 0 && i < threads / 128
                                ? new std::barrier<>(128) : nullptr);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      memset(buf.data(), 0xff, buf.size());
      std::barrier<> bar(threads);
      emu_bar = &bar;
      std::vector<std::thread> team;
      for (int t = 0; t < threads; ++t)
        team.emplace_back([=]() {
          threadIdx = {t, 0, 0};
          blockIdx = {int(bx), int(by), 0};
          emu_groups.clear();
          emu_open.clear();
          kernel(args...);
        });
      for (std::thread& t : team) t.join();
    }
}
