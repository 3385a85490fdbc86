// A CPU stand-in for the CUDA subset that lama_tpu_torch/csrc/fourier_unit.cu
// and the fp32 instances of csrc/stem_conv.cu and csrc/reflect_conv.cu use,
// so that g++ can build a kernel's source and run it on the host
// (tests/test_torch_{fourier_unit,stem_conv,reflect_conv}_emulated.py): each CUDA thread of
// a block is a std::thread, __syncthreads a std::barrier, and a cp.async a copy
// deferred until the wait_group that retires its group, as on the card.
// Blocks run one after another, each over shared memory filled with 0xff
// bytes (NaN floats), so a read of anything not staged shows.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
using std::min;
#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct EmuDim { int x, y, z; };
inline thread_local EmuDim threadIdx, blockIdx;
inline EmuDim gridDim;
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
struct __nv_bfloat16 { uint16_t v; };
inline __nv_bfloat16 __float2bfloat16(float f) {   // round to nearest even
  unsigned u; memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 0 };
template <typename F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
// a card of EMU_SMS SMs: a persistent grid of that many blocks walks
// several tiles each at the tests' small shapes
constexpr int EMU_SMS = 3;
enum { cudaDevAttrMultiProcessorCount = 0 };
inline int cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline int cudaDeviceGetAttribute(int* value, int, int) {
  *value = EMU_SMS;
  return 0;
}

inline unsigned char* emu_smem = nullptr;
inline std::barrier<>* emu_bar = nullptr;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline uint32_t __cvta_generic_to_shared(const void*) { return 0; }

struct EmuCopy { uint32_t dst; const void* src; int size, bytes; };
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline thread_local std::vector<EmuCopy> emu_open;
inline void emu_fail(const char* what) { fprintf(stderr, "%s\n", what); abort(); }
// warp-level code (the bf16 instances of stem_conv.cu and reflect_conv.cu)
// builds but does not run here
inline void __syncwarp() { emu_fail("__syncwarp: the stand-in has no warps"); }
inline void emu_cp(uint32_t dst, const void* src, int size, int bytes) {
  if (dst % size) emu_fail("cp.async: misaligned shared address");
  if (bytes && reinterpret_cast<uintptr_t>(src) % size)
    emu_fail("cp.async: misaligned global address");
  if (bytes < 0 || bytes > size) emu_fail("cp.async: source size");
  emu_open.push_back({dst, src, size, bytes});
}
inline void emu_commit() { emu_groups.push_back(emu_open); emu_open.clear(); }
inline void emu_wait(int pending) {
  while (int(emu_groups.size()) > pending) {
    for (const EmuCopy& c : emu_groups.front()) {
      memset(emu_smem + c.dst, 0, c.size);
      if (c.bytes) memcpy(emu_smem + c.dst, c.src, c.bytes);
    }
    emu_groups.erase(emu_groups.begin());
  }
}
template <typename K, typename... A>
void emu_launch(K kernel, unsigned grid, int threads, int smem, cudaStream_t,
                A... args) {
  std::vector<unsigned char> buf(smem > 0 ? smem : 1);
  emu_smem = buf.data();
  gridDim = {int(grid), 1, 1};
  for (unsigned b = 0; b < grid; ++b) {
    memset(buf.data(), 0xff, buf.size());
    std::barrier<> bar(threads);
    emu_bar = &bar;
    std::vector<std::thread> team;
    for (int t = 0; t < threads; ++t)
      team.emplace_back([=]() {
        threadIdx = {t, 0, 0};
        blockIdx = {int(b), 0, 0};
        emu_groups.clear();
        emu_open.clear();
        kernel(args...);
      });
    for (std::thread& t : team) t.join();
  }
}
