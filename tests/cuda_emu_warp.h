// Warp-level stand-ins for tests/cuda_emu.h, for the int8 conv
// (lama_tpu_torch/csrc/conv_int8.cu; tests/test_torch_int8_emulated.py):
// ldmatrix, mma.sync m16n8k32 s8, __shfl_xor_sync, a two-dimensional grid,
// and the few intrinsics and types that source uses beyond cuda_emu.h's.
// The 32 threads of a warp meet at a barrier of their own; a collective
// writes each lane's operands to a per-warp slot, waits, computes its own
// lane's result from every lane's operands as the PTX ISA lays the
// fragments out, and waits again before the slot is reused.
#pragma once
#include "cuda_emu.h"
#include <memory>
#include <mutex>

struct int2 { int x, y; };
inline int2 make_int2(int a, int b) { return {a, b}; }
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

// ldmatrix.x4: lane l reads, of matrix j, row l / 4 (whose address lane
// 8 j + l / 4 holds) at 32-bit word l % 4
inline void emu_ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  EmuWarp& w = emu_warp();
  const int lane = emu_lane();
  w.slot[lane][0] = addr;
  w.bar->arrive_and_wait();
  for (int j = 0; j < 4; ++j)
    memcpy(&r[j], emu_smem + w.slot[8 * j + lane / 4][0] + 4 * (lane % 4), 4);
  w.bar->arrive_and_wait();
}

// mma.sync.m16n8k32.row.col s8: A register i of lane (g, t) holds row g +
// 8 (i % 2), columns 4 t + 16 (i / 2) .. + 3; B register i holds column g,
// rows 4 t + 16 i .. + 3; D element e holds row g + 8 (e / 2), column 2 t +
// e % 2
inline void emu_mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                       uint32_t b1) {
  EmuWarp& w = emu_warp();
  const int lane = emu_lane();
  for (int i = 0; i < 4; ++i) w.slot[lane][i] = a[i];
  w.slot[lane][4] = b0;
  w.slot[lane][5] = b1;
  w.bar->arrive_and_wait();
  int8_t A[16][32], B[32][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    for (int i = 0; i < 4; ++i)
      for (int e = 0; e < 4; ++e)
        A[g + 8 * (i % 2)][4 * t + 16 * (i / 2) + e] =
            int8_t(w.slot[l][i] >> (8 * e));
    for (int i = 0; i < 2; ++i)
      for (int e = 0; e < 4; ++e)
        B[4 * t + 16 * i + e][g] = int8_t(w.slot[l][4 + i] >> (8 * e));
  }
  const int g = lane / 4, t = lane % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2), col = 2 * t + e % 2;
    int s = 0;
    for (int k = 0; k < 32; ++k) s += int(A[row][k]) * int(B[k][col]);
    d[e] += s;
  }
  w.bar->arrive_and_wait();
}

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
  gridDim = {int(grid.x), int(grid.y), 1};
  for (int i = 0; i < threads / 32; ++i)
    emu_warps[i].bar = std::make_unique<std::barrier<>>(32);
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
