// bf16 3x3 reflect-padded convolution of any channel counts, stride 1
// ('same') or stride 2, as one implicit GEMM on Hopper's warpgroup
// tensor-core instructions (wgmma), for sm_90a. Bound to Python through
// lama_conv3x3_wgmma (stride 1) and lama_conv3x3_s2_wgmma (stride 2) at the
// bottom (ctypes; see lama_tpu_torch/ops/kernels/conv3x3_wgmma.py, whose
// constants, descriptors and weight packing mirror this file's).
//
// Replaces the bf16 paths of four TPU kernels, which compute the same
// function at different channel counts and strides:
//   lama_tpu/ops/pallas/halo_conv.py::halo_conv3x3_reflect (:53), kernel 6
//     (the GlobalGenerator's 512 -> 512 ResnetBlock convs, any C and C_out);
//   lama_tpu/ops/pallas/reflect_conv.py::reflect_conv3x3_taps (:465),
//     kernel 3 (the FFC's l2g 128 -> 384 and g2l 384 -> 128 convs);
//   reflect_conv.py::reflect_conv3x3_cols (:130), kernel 2 (the FFC's 36
//     l2l 128 -> 128 convs);
//   reflect_conv.py::reflect_down_conv3x3 (:230), kernel 4 (stride 2: the
//     four downsample convs, 64 -> 128 at 512^2 to 256 -> 384 at 128^2).
// Their fp32 paths stay the SIMT kernels of halo_conv.cu and reflect_conv.cu.
//
// Bound: 2 * 9 * C * C_out FLOP per output pixel against (C + C_out) * 2
// bytes in and out at stride 1: ~2300 FLOP/B at 512 -> 512, ~1000 FLOP/B at
// 128 -> 384, both far above the H100's ~295 FLOP/B ridge, so the tensor
// cores bound it. At stride 2 an output pixel reads four input pixels, so
// the downsamples sit near the ridge: down1 (64 -> 128) is bound by its
// bytes, down2 and down3's l2g by the tensor cores. What the design does:
// keep the tensor cores fed, and read each input byte from HBM once.
//   * Tiles. A block owns 16 x 16 output pixels (M = 256) and 128 output
//     channels (N), and walks K = 9 taps x C in chunks of input channels.
//     Two consumer warpgroups each own 8 output rows: two m64 sub-tiles of
//     8 x 8 pixels, each an m64n128 fp32 accumulator in registers.
//   * Operands from the staged halo, no im2col. Each chunk stages the tile's
//     reflect-mapped halo once, in wgmma's no-swizzle core-matrix layout:
//     [8-channel group plane][halo pixel][8 channels], 16 B per pixel. A
//     core matrix (8 rows x 16 B) is then 8 neighbouring halo pixels of one
//     row, and LBO (the next 8 channels) is one group plane.
//     Stride 1: the halo is 18 x 18 pixels; the eight 8-row groups of an m64
//     sub-tile (8 output rows x 8 columns) lie one halo row apart (SBO = 18
//     x 16 B), and tap (ky, kx) moves only the descriptor's start, by
//     (ky * 18 + kx) x 16 B.
//     Stride 2: the width-pair view of the TPU kernel (reflect_conv.py:193,
//     x.reshape(b, h, w / 2, 2c)). Input columns 2p and 2p + 1 are slots 0
//     and 1 of pair p, and output column j reads pair j - 1 slot 1 (kx = 0),
//     pair j slot 0 (kx = 1) and pair j slot 1 (kx = 2). So eight output
//     columns read eight consecutive pairs of one slot: the stride leaves
//     the columns. The halo is 33 rows x 17 pairs, each slot's 8-channel
//     groups their own planes ([slot * GROUPS + group]); an m64 sub-tile's
//     8-row groups lie two halo rows apart (SBO = 2 x 17 x 16 B), and tap
//     (ky, kx) again moves only the start: plane (kx == 1 ? 0 : GROUPS),
//     halo row ky, pair column (kx == 0 ? 0 : 1). Pair -1's slot 1 is input
//     column -1, which the copy's address map reflects to column 1: the TPU
//     kernel's left[:, 0:1] fix-up (reflect_conv.py:211).
//     (A swizzled layout would break here: a one-pixel shift is not a
//     multiple of the swizzle's 128-byte row, and A in registers would need
//     an ldmatrix per tap.) So each staged halo value feeds all its taps,
//     and each staged weight 256 pixels.
//   * Weights packed once per call, by the wrapper, in 32-channel chunks:
//     [n tile][chunk][tap][8-channel group][128 channels][8], zero-filled
//     past C and C_out, so a stride-1 stage's 72 KB of weights is one
//     contiguous run of 16-byte copies, and B's core matrices are 8 output
//     channels x 16 B (SBO 128 B, LBO 128 x 16 B). A stride-2 stage takes
//     half a packed chunk: two groups of each tap, nine runs of 4 KB.
//   * Asynchronous staging: chunk k + 1's halo (cp.async 16-byte copies
//     from reflect-mapped addresses; TMA's out-of-bounds fill is zeros, not
//     a reflection) and weights load while chunk k's wgmma.m64n128k16 run;
//     cp.async's wait_group and a fence.proxy.async hand each stage to the
//     tensor cores. Stride 1: two stages of 32 channels (2 x 92.25 KB of the
//     227 KB). Stride 2: a 32-channel stage would hold a 70.1 KB halo beside
//     72 KB of weights, and two do not fit; so three stages of 16 channels
//     (3 x 71.06 KB: a 35.06 KB halo, 36 KB of weights), with two chunks in
//     flight behind the one the tensor cores read (two stages of 16
//     measured slower at every downsample shape; PERF.md). Against the
//     other fit, an 8 x 16-pixel tile at 32 channels, this keeps M = 256:
//     half the weight bytes refilled per output pixel (the refill, not the
//     drain, sets a chunk's time; PERF.md), and half the weights' L2
//     traffic on down1, whose input bytes bound it. (Keeping one chunk's
//     products queued across the chunk boundary, wgmma.wait_group 1 and a
//     second barrier per chunk, measured slower at stride 1: PERF.md.)
//   * Any shape: channel tails zero-filled by the copies (the source size 0;
//     element loads where C is not a multiple of 8), partial edge tiles
//     masked at the store. Epilogue: bias added in fp32, one rounding to
//     bf16, the tile staged in shared memory and stored as 16-byte vectors
//     of 8 channels where C_out % 8 == 0.
//
// No backward kernel: the TPU kernels have none; the port's autograd wrapper
// takes the plain version's VJP.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE_H = 16, TILE_W = 16;          // output pixels per block
constexpr int SUB = 8;                           // an m64 sub-tile: 8 x 8 px
constexpr int BLOCK_N = 128;                     // output channels per block
constexpr int CHUNK_C = 32;                      // input channels per stage (s1)
constexpr int STAGES = 2;                        // pipeline stages (s1)
constexpr int S2_CHUNK_C = 16;                   // input channels per stage (s2)
constexpr int S2_STAGES = 3;                     // pipeline stages (s2)
constexpr int GROUP_C = 8;                       // channels per 16-byte row
constexpr int PACK_GROUPS = CHUNK_C / GROUP_C;   // groups per packed chunk
constexpr int THREADS = 256;                     // two consumer warpgroups
constexpr int OUT_PITCH = BLOCK_N + 8;           // bf16 output staging pitch
constexpr int SMEM_LIMIT = 232448;               // shared memory of one block
// B (weights) descriptor strides, bytes, K-major
constexpr int B_LBO = BLOCK_N * 16, B_SBO = GROUP_C * 16;
static_assert(TILE_H == 2 * SUB && TILE_W == 2 * SUB, "two warpgroups x two sub-tiles");

// the tile plan at stride S (1 or 2)
template <int S> struct Plan {
  static constexpr int CHUNK = S == 1 ? CHUNK_C : S2_CHUNK_C;
  static constexpr int RING = S == 1 ? STAGES : S2_STAGES;
  static constexpr int GROUPS = CHUNK / GROUP_C;       // groups per slot
  static constexpr int PLANES = S * GROUPS;            // halo group planes
  static constexpr int HALO_H = S * (TILE_H - 1) + 3;  // 18; 33 rows
  static constexpr int HALO_W = TILE_W + 3 - S;        // 18 pixels; 17 pairs
  static constexpr int HALO_PIX = HALO_H * HALO_W;
  static constexpr int HALO_BYTES = PLANES * HALO_PIX * 16;
  static constexpr int WEIGHT_BYTES = 9 * CHUNK * BLOCK_N * 2;
  static constexpr int STAGE_BYTES = HALO_BYTES + WEIGHT_BYTES;
  static constexpr int SMEM_BYTES = RING * STAGE_BYTES;
  // A (halo) descriptor strides, bytes, K-major: the next 8 channels, the
  // next output row of the sub-tile (S halo rows)
  static constexpr int A_LBO = HALO_PIX * 16, A_SBO = S * HALO_W * 16;
  static constexpr int HALO_ITEMS = PLANES * HALO_PIX;   // copies per stage
  static constexpr int HALO_PER_THREAD = (HALO_ITEMS + THREADS - 1) / THREADS;
  static constexpr int WEIGHT_PER_THREAD = WEIGHT_BYTES / 16 / THREADS;
  static constexpr int SPLIT = CHUNK_C / CHUNK;   // stages per packed chunk
  static_assert(S == 1 || S == 2, "stride");
  static_assert(WEIGHT_BYTES % (16 * THREADS) == 0, "weight copies per thread");
  static_assert(CHUNK_C % CHUNK == 0 && CHUNK % 16 == 0, "chunk");
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory of one block");
  static_assert(TILE_H * TILE_W * OUT_PITCH * 2 <= SMEM_BYTES, "output stage");
  // descriptor fields are 14 bits in 16-byte units
  static_assert(SMEM_LIMIT / 16 < (1 << 14) && A_LBO / 16 < (1 << 14), "descriptor");
};

// torch 'reflect' index for |overhang| < n; the clamp only matters for halo
// rows/cols of a partial edge tile whose outputs are never stored.
__device__ __forceinline__ int reflect_idx(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, LBO and
// SBO in 16-byte units (14 bits each), layout type 0
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int lbo, int sbo) {
  return uint64_t((addr >> 4) & 0x3FFF) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed copy groups are pending
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// make this thread's shared-memory writes visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma window
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x 128, fp32, registers) += A (64 x 16, bf16, smem) * B^T (128 x 16)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// x: (B, H, W, C) NHWC bf16; wpk: the packed weights (see the header);
// bias: (Co,) fp32 or null; out: (B, H / S, W / S, Co) NHWC bf16 (H, W even
// at S = 2). vec_x: C % 8 == 0 and x 16-byte aligned; vec_out: the same for
// Co and out.
template <int S>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int H, int W, int C, int Co, int vec_x, int vec_out) {
  using P = Plan<S>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int Ho = H / S, Wo = W / S;
  const int tid = threadIdx.x;
  const int tiles_w = (Wo + TILE_W - 1) / TILE_W;
  const int r0 = (blockIdx.x / tiles_w) * TILE_H;   // output tile origin
  const int c0 = (blockIdx.x % tiles_w) * TILE_W;
  const int nt = blockIdx.y, n0 = nt * BLOCK_N;
  const int b = blockIdx.z;
  const int chunks = (C + P::CHUNK - 1) / P::CHUNK;
  const int packed_chunks = (C + CHUNK_C - 1) / CHUNK_C;
  const bf16* xb = x + size_t(b) * H * W * C;
  const bf16* wn = wpk + size_t(nt) * packed_chunks * (9 * CHUNK_C * BLOCK_N);

  // this thread's halo copies: item i = tid + q * THREADS is group plane
  // i % PLANES (slot, then 8-channel group) of halo pixel i / PLANES; its
  // reflect-mapped source pixel (input row S r0 - 1 + halo row, column
  // S (c0 - 1 + halo column) + slot) is the same for every chunk
  int src_pix[P::HALO_PER_THREAD];
#pragma unroll
  for (int q = 0; q < P::HALO_PER_THREAD; ++q) {
    const int i = tid + q * THREADS;
    const int p = i / P::PLANES, slot = (i % P::PLANES) / P::GROUPS;
    const int gr = reflect_idx(S * r0 - 1 + p / P::HALO_W, H);
    const int gc = reflect_idx(S * (c0 - 1 + p % P::HALO_W) + slot, W);
    src_pix[q] = gr * W + gc;
  }

  auto load_stage = [&](int stage, int chunk) {
    const uint32_t st = smem_base + stage * P::STAGE_BYTES;
    const int ci0 = chunk * P::CHUNK;
#pragma unroll
    for (int q = 0; q < P::HALO_PER_THREAD; ++q) {
      const int i = tid + q * THREADS;
      if (i >= P::HALO_ITEMS) break;
      const int g = i % P::GROUPS, pl = i % P::PLANES, p = i / P::PLANES;
      const int c = ci0 + g * GROUP_C;
      const uint32_t dst = st + (pl * P::HALO_PIX + p) * 16;
      const bf16* src = xb + size_t(src_pix[q]) * C + c;
      if (vec_x) {
        cp_async16(dst, c < C ? src : xb, c < C ? 16 : 0);   // 0: zero-fill
      } else {
        __align__(16) bf16 v[GROUP_C];
#pragma unroll
        for (int e = 0; e < GROUP_C; ++e)
          v[e] = c + e < C ? src[e] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(smem + (dst - smem_base)) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
    // stage chunk `chunk` is part chunk % SPLIT of packed chunk
    // chunk / SPLIT: GROUPS of the PACK_GROUPS groups of each tap
    const bf16* wsrc = wn + (size_t(chunk / P::SPLIT) * 9 * PACK_GROUPS +
                             (chunk % P::SPLIT) * P::GROUPS) * BLOCK_N * GROUP_C;
#pragma unroll
    for (int q = 0; q < P::WEIGHT_PER_THREAD; ++q) {
      const int i = tid + q * THREADS;
      const int tap = i / (P::GROUPS * BLOCK_N), r = i % (P::GROUPS * BLOCK_N);
      cp_async16(st + P::HALO_BYTES + i * 16,
                 wsrc + (tap * PACK_GROUPS * BLOCK_N + r) * GROUP_C, 16);
    }
  };

  // warpgroup wg owns output rows 8 wg .. 8 wg + 7, columns 0-7 (acc0) and
  // 8-15 (acc1)
  const int wg = tid / 128;
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;

#pragma unroll
  for (int s = 0; s < P::RING - 1; ++s) {
    if (s < chunks) load_stage(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<P::RING - 2>();
    fence_proxy_async();
    __syncthreads();   // chunk k staged by every thread; chunk k - 1 consumed
    const uint32_t st = smem_base + (k % P::RING) * P::STAGE_BYTES;
    const uint64_t a_base =
        make_desc(st + wg * SUB * S * P::HALO_W * 16, P::A_LBO, P::A_SBO);
    const uint64_t b_base = make_desc(st + P::HALO_BYTES, B_LBO, B_SBO);
    fence_acc(acc0);
    fence_acc(acc1);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      // stride 1: halo pixel column kx; stride 2: pair column
      // (kx == 0 ? 0 : 1) of slot (kx == 1 ? 0 : 1)
      const int col = S == 1 ? kx : (kx + 1) / 2;
      const int slot = S == 1 ? 0 : (kx + 1) % 2;
#pragma unroll
      for (int j = 0; j < P::CHUNK / 16; ++j) {
        // descriptor start addresses advance in 16-byte units
        const uint64_t da = a_base + ((slot * P::GROUPS + 2 * j) * P::HALO_PIX +
                                      ky * P::HALO_W + col);
        const uint64_t db = b_base + (tap * P::GROUPS + 2 * j) * BLOCK_N;
        wgmma_m64n128k16(acc0, da, db);
        wgmma_m64n128k16(acc1, da + SUB, db);
      }
    }
    wgmma_commit();
    // chunk k + RING - 1 loads (into chunk k - 1's stage) while the tensor
    // cores run chunk k
    if (k + P::RING - 1 < chunks)
      load_stage((k + P::RING - 1) % P::RING, k + P::RING - 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_acc(acc0);
    fence_acc(acc1);
  }
  __syncthreads();   // every warpgroup's wgmma reads are done: reuse smem

  // epilogue: + bias in fp32, one rounding to bf16, staged pixel-major
  bf16* stage_out = reinterpret_cast<bf16*>(smem);   // [256 px][OUT_PITCH]
  const int lane = tid % 32, warp = (tid % 128) / 32;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int v = 0; v < 64; v += 2) {
      const int row = 16 * warp + lane / 4 + 8 * ((v >> 1) & 1);   // D row
      const int col = 8 * (v >> 2) + 2 * (lane % 4);
      const int m = (wg * SUB + row / 8) * TILE_W + u * SUB + row % 8;
      const int n = n0 + col;
      const float b0 = (bias && n < Co) ? bias[n] : 0.f;
      const float b1 = (bias && n + 1 < Co) ? bias[n + 1] : 0.f;
      const float a0 = u ? acc1[v] : acc0[v], a1 = u ? acc1[v + 1] : acc0[v + 1];
      *reinterpret_cast<__nv_bfloat162*>(stage_out + m * OUT_PITCH + col) =
          __floats2bfloat162_rn(a0 + b0, a1 + b1);
    }
  }
  __syncthreads();
  constexpr int VPP = BLOCK_N / 8;   // 16-byte vectors per pixel
  for (int i = tid; i < TILE_H * TILE_W * VPP; i += THREADS) {
    const int m = i / VPP, v = i % VPP;
    const int r = r0 + m / TILE_W, c = c0 + m % TILE_W, n = n0 + v * 8;
    if (r >= Ho || c >= Wo || n >= Co) continue;
    const bf16* s = stage_out + m * OUT_PITCH + v * 8;
    bf16* o = out + ((size_t(b) * Ho + r) * Wo + c) * Co + n;
    if (vec_out) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < 8 && n + e < Co; ++e) o[e] = s[e];
    }
  }
}

template <int S>
int launch(const void* x, const void* wpk, const void* bias, void* out, int B,
           int H, int W, int C, int Co, void* stream) {
  if (B < 1 || C < 1 || Co < 1 || H < 2 || W < 2 || H % S || W % S ||
      reinterpret_cast<uintptr_t>(wpk) % 16)
    return int(cudaErrorInvalidValue);
  const int vec_x = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_out = Co % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan<S>::SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  const int Ho = H / S, Wo = W / S;
  const int tiles = ((Ho + TILE_H - 1) / TILE_H) * ((Wo + TILE_W - 1) / TILE_W);
  dim3 grid(tiles, (Co + BLOCK_N - 1) / BLOCK_N, B);
  conv3x3_wgmma_kernel<S><<<grid, THREADS, Plan<S>::SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpk),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, C, Co,
      vec_x, vec_out);
  return int(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, C) bf16 NHWC; wpk: ceil(Co / 128) * ceil(C / 32) * 9 * 32 * 128
// bf16 (lama_tpu_torch/ops/kernels/conv3x3_wgmma.py::pack_conv3x3_weight),
// 16-byte aligned; bias: (Co,) float32 or null; out: (B, H, W, Co) bf16
// NHWC. Any C, Co >= 1 and H, W >= 2. Returns a cudaError_t value (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int lama_conv3x3_wgmma(const void* x, const void* wpk,
                                  const void* bias, void* out, int B, int H,
                                  int W, int C, int Co, void* stream) {
  return launch<1>(x, wpk, bias, out, B, H, W, C, Co, stream);
}

// The same at stride 2: H, W are the input's, both even; out is
// (B, H / 2, W / 2, Co) bf16 NHWC.
extern "C" int lama_conv3x3_s2_wgmma(const void* x, const void* wpk,
                                     const void* bias, void* out, int B, int H,
                                     int W, int C, int Co, void* stream) {
  return launch<2>(x, wpk, bias, out, B, H, W, C, Co, stream);
}
