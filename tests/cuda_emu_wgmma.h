// Warpgroup stand-ins for tests/cuda_emu_warp.h, for the int8 conv's GEMM
// (lama_tpu_torch/csrc/conv_int8.cu; tests/test_torch_int8_emulated.py):
// wgmma.mma_async m64nNk32 s32.s8.s8 with A and B in shared memory by
// no-swizzle descriptors, and wgmma.fence, commit_group, wait_group and
// fence.proxy.async, each a barrier of the warpgroup's 128 threads.
//
// As on the card, a wgmma's products land only at the wait_group that
// retires its group: each thread queues its own (descriptors, accumulator)
// and the wait computes, for that thread, its fragment of every retired
// product straight from the emulated shared memory as it then stands
// (filled with 0xff bytes before each block, so a stale or unstaged read
// shows as a -1 code). A descriptor is decoded field by field (start, LBO
// and SBO in 16-byte units, 14 bits each; base offset and layout type must
// be 0, the no-swizzle form) and every address it yields is checked against
// the block's shared memory. Element (row r, K byte k) of an operand lies
// at start + (r / 8) SBO + (k / 16) LBO + (r % 8) 16 + k % 16: 8 rows of
// 16 bytes a core matrix, K-major. Sum i of a thread (warp w of the
// warpgroup, lane l) is row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4)
// + 2 (l % 4) + i % 2.
#pragma once
#include "cuda_emu_warp.h"

struct EmuWgmma { uint64_t da, db; int* d; int n; };
inline thread_local std::vector<EmuWgmma> emu_wg_open;
inline thread_local std::vector<std::vector<EmuWgmma>> emu_wg_groups;
inline thread_local bool emu_wg_fenced = false;

// (start, LBO, SBO) in bytes of a no-swizzle descriptor
struct EmuDesc { uint32_t start, lbo, sbo; };
inline EmuDesc emu_desc(uint64_t d) {
  const uint64_t fields = 0x3FFFull | (0x3FFFull << 16) | (0x3FFFull << 32);
  if (d & ~fields) emu_fail("wgmma: descriptor base offset or swizzle set");
  return {uint32_t(d & 0x3FFF) << 4, uint32_t((d >> 16) & 0x3FFF) << 4,
          uint32_t((d >> 32) & 0x3FFF) << 4};
}
inline int8_t emu_operand(const EmuDesc& m, int r, int k) {
  const size_t a = size_t(m.start) + (r / 8) * size_t(m.sbo) +
                   (k / 16) * size_t(m.lbo) + (r % 8) * 16 + k % 16;
  if (a >= emu_smem_bytes) emu_fail("wgmma: operand outside shared memory");
  return int8_t(emu_smem[a]);
}

inline void emu_wgmma_fence() {
  emu_warpgroup_sync();
  emu_wg_fenced = true;
}
inline void emu_fence_proxy_async() { emu_warpgroup_sync(); }
inline void emu_wgmma_s8(int* d, uint64_t da, uint64_t db, int n) {
  if (!emu_wg_fenced) emu_fail("wgmma: no wgmma.fence since the last wait");
  emu_desc(da);
  emu_desc(db);
  emu_wg_open.push_back({da, db, d, n});
}
inline void emu_wgmma_commit() {
  emu_warpgroup_sync();
  emu_wg_groups.push_back(emu_wg_open);
  emu_wg_open.clear();
}
inline void emu_wgmma_wait(int pending) {
  emu_warpgroup_sync();
  if (!emu_wg_open.empty()) emu_fail("wgmma: wait with an uncommitted wgmma");
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  while (int(emu_wg_groups.size()) > pending) {
    for (const EmuWgmma& op : emu_wg_groups.front()) {
      const EmuDesc a = emu_desc(op.da), b = emu_desc(op.db);
      for (int i = 0; i < op.n / 2; ++i) {
        const int row = 16 * w + lane / 4 + 8 * ((i / 2) % 2);
        const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        int s = 0;
        for (int k = 0; k < 32; ++k)
          s += int(emu_operand(a, row, k)) * int(emu_operand(b, col, k));
        op.d[i] += s;
      }
    }
    emu_wg_groups.erase(emu_wg_groups.begin());
  }
  emu_wg_fenced = false;
  emu_warpgroup_sync();
}
