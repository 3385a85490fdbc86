// int8 convolutions for Hopper (sm_90a): the quantized Conv2d and
// ConvTranspose2d of int8 serving, bound to Python through the extern "C"
// launchers at the bottom (ctypes; lama_tpu_torch/ops/kernels/conv_int8.py
// holds the plan, the packing and the constants this file mirrors).
//
// No TPU kernel stands behind this file: in lama_tpu the quantized convs
// are XLA convolutions with int32 accumulation (lama_tpu/ops/quant.py:108
// and :151), and PyTorch has no int8 convolution on CUDA. It serves the
// eligible convs of both generator families: big-lama's four downsamples,
// its 108 3x3 FFC convs and 72 SpectralTransform 1x1 convs at 64^2 and its
// three ConvTranspose layers; the GlobalGenerator's downsamples, block
// convs and ConvTranspose layers.
//
// Three launches a conv (two with a calibrated scale):
//   amax_kernel      max |x| over the whole tensor (dynamic scale only);
//   quantize_kernel  x (bf16 or fp32, any strides) -> int8 NHWC codes,
//                    clamp(rint(x / s_x), -127, 127): a division and round
//                    half to even, as torch.round; channels padded with
//                    zeros to a multiple of 32;
//   conv_kernel      one implicit GEMM, no im2col: M = output pixels, N =
//                    output channels, K = taps x 32-channel chunks, on
//                    wgmma.mma_async m64nNk32 s8 x s8 -> s32 with both
//                    operands in shared memory, the sums in int32
//                    registers; epilogue float(acc) * (s_x * s_w[n]) +
//                    bias[n] in fp32, rounded once per operation as
//                    lama_tpu's dequantize is, then stored NHWC (the
//                    channels-last layout the next layer reads) as fp32 or
//                    bf16, or the raw int32 sums (the card's exactness
//                    check). int32 sums do not depend on the order of
//                    accumulation (|sum| <= 127^2 x 4608 < 2^31), so the
//                    result is bit-equal to an exact plain version.
// A conv is a list of "phases", each a stride-s gather: output pixel (b,
// hg, wg) of phase p lands at (hg * ostride + oy0, wg * ostride + ox0) and
// reads, for tap t, input pixel (hg * s + dy[t], wg * s + dx[t]) through
// the border map (zero: outside reads as 0; reflect: -i and 2n - 2 - i;
// replicate: clamped) with weight slice wtap[t]. A Conv2d is one phase of
// kh * kw taps. A ConvTranspose2d of stride 2 is four phases (the output's
// row and column parities) of 1, 2, 2 and 4 taps over the undilated input
// with a zero border, so no inserted zeros are staged. The Python plan
// builds the phases; the CPU tests replay it in numpy against the plain
// conv.
//
// Bound: at big-lama's 64^2 convs the int8 products are 1,979 TOP/s work
// (e.g. l2g 128 -> 384 at b16: 58 GOP, 0.029 ms) against 8-25 MB of codes
// and outputs (0.003-0.008 ms at 3.35 TB/s), so operations bound them;
// the full-resolution ConvTranspose and downsample layers move more bytes
// per product. The GEMM's design, Hopper's warpgroup tensor-core path:
//   * Tiles. A block owns 256 output pixels of one phase (M, flat over
//     batch and grid) x BN output channels (N: 64, 128 or 192, whichever
//     pads C_out least; ties to the wider), one block an SM (160, 192 or
//     224 KB of shared memory). Two consumer warpgroups each own two m64
//     sub-tiles: 2 x BN / 2 int32 sums a thread (128 registers at BN 128,
//     192 at BN 192). The channel tiles of one pixel tile are adjacent in
//     the grid (they share its codes in L2).
//   * Operands. Each K step is one 32-channel chunk of one tap: an int8
//     wgmma k32 step spans 32 bytes, as a bf16 k16 step does, so
//     conv3x3_wgmma.cu's no-swizzle descriptors carry over. Both operands
//     are K-major (the PTX ISA requires it for 8-bit types): the codes
//     (B, H, W, Cp) and the packed weight (taps, COp, Cp) already are.
//   * Staging, no im2col and no TMA (TMA cannot apply a reflect map):
//     every thread gathers one row of A, its output pixel's 32 bytes of
//     each chunk of the stage through the border map, with cp.async
//     16-byte copies (source size 0: the zero border, rows past M, a dead
//     chunk), and a share of B's rows. The copies land in wgmma's
//     core-matrix layout: one plane a 16-byte K group, 8 consecutive rows
//     x 16 B a core matrix, SBO 128 B, LBO one plane (so the descriptor's
//     start is a chunk's first 16 bytes of K and start + LBO its second).
//     A pipeline stage is four chunks (128 bytes of K: 48 KB at BN 128) in
//     a 4-deep ring; stage s + 3 loads while the tensor cores run stage s.
//     Each stage is handed over by cp.async.wait_group, fence.proxy.async
//     (the copies are generic-proxy writes that wgmma reads through the
//     async proxy) and one __syncthreads; then wgmma.fence, eight wgmma a
//     warpgroup, commit_group, and wait_group 0 before the slot is reused.
//   * K runs over 128-byte channel groups, then taps, then the group's
//     chunks, so consecutive stages gather overlapping pixels.
//   * The epilogue stages the int32 tile in shared memory, works out each
//     row's output offset once, and stores each pixel's 8-channel runs as
//     16-byte vectors.
// What bounds it on the card: the gather. Each staged weight byte feeds
// 256 pixels, but each code byte feeds only BN columns and is gathered
// again for every tap: 48 KB of L2 reads a stage at BN 128 for 1024
// cycles of tensor work, and the gather ran at 2-3 TB/s over all SMs. At
// l2g (b16, device ms; `python -m lama_tpu_torch.tools.conv_int8_time`
// on variants of this file): the whole GEMM 0.19 at BN 128, 0.17 with its
// wgmma left out, 0.12 with its in-loop loads left out; cp.async.ca (L1
// reuse between taps), a 3-deep ring, 64-byte stages and lane groups of
// one 128-byte line each measured no faster. The epilogue is not
// overlapped with any load: at BN 192, l2g's first three stages and
// barriers alone take 0.040, the epilogue adds 0.034 of the whole 0.148.
// A staged halo (A reuse across taps, as conv3x3_wgmma.cu does), weight
// multicast in a cluster and a persistent grid that stores one tile while
// the next one loads are what would cut it. Measured the same way, NVIDIA
// H100 80GB HBM3, 700.00 W: l2l 0.065, l2g 0.148, g2l 0.153, the
// SpectralTransform's 1x1s 0.046 and 0.062 (torch._int_mm on the same
// GEMMs 0.14 and 0.12), the 512 -> 512 block conv 0.738 (bound 0.156); a
// big-lama forward's 187 GEMMs 20.7 ms. PERF.md has the rest.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

constexpr int MAX_TAPS = 9;
constexpr int MAX_PHASES = 4;

struct Int8Phase {
  int oy0, ox0;        // output offset of the phase's grid
  int hg, wg;          // the phase's output grid
  int taps;
  int dy[MAX_TAPS], dx[MAX_TAPS];   // input offset of each tap
  int wtap[MAX_TAPS];               // its packed-weight slice
};

struct Int8ConvArgs {
  const int8_t* x;     // (B, H, W, Cp) codes, zero past C
  const int8_t* w;     // (T, COp, Cp) packed codes, zero past C and C_out
  const float* amax;   // the activation amax, a device scalar
  const float* s_w;    // (Co,) weight scales
  const float* bias;   // (Co,) or null
  void* out;           // (B, Ho, Wo, Co): fp32, bf16 or int32
  int out_kind;        // OUT_FP32, OUT_BF16 or OUT_ACC
  int B, H, W, Cp;
  int Ho, Wo, Co, COp;
  int stride, ostride; // input stride of the gather, output stride
  int border;          // BORDER_ZERO, BORDER_REFLECT or BORDER_REPLICATE
  int n_phases;
  Int8Phase phase[MAX_PHASES];
};

namespace {

enum { OUT_FP32 = 0, OUT_BF16 = 1, OUT_ACC = 2 };
enum { BORDER_ZERO = 0, BORDER_REFLECT = 1, BORDER_REPLICATE = 2 };

constexpr int THREADS = 256;     // two consumer warpgroups
constexpr int BM = 256;          // output pixels a block tile: four m64 sub-tiles
constexpr int CHUNK = 32;        // input channels (bytes) a K chunk: one k32 step
constexpr int KCH = 4;           // chunks a pipeline stage (128 bytes of K)
constexpr int STAGES = 4;        // pipeline ring depth
constexpr int GROUP = 16;        // bytes of K a core-matrix row
constexpr int COP_ALIGN = 128;   // the packed weight's C_out padding
constexpr int QTHREADS = 256;    // quantize_kernel / amax_kernel blocks
constexpr int SMEM_LIMIT = 232448;   // shared memory of one block

// A stage holds, for each of its KCH * 2 K groups, a plane of A (BM rows
// x 16 B) and a plane of B (BN rows x 16 B): 8 consecutive rows of a plane
// are one core matrix (SBO 128 B), the next 16 bytes of K the next plane
// (LBO one plane). Thread t stages row t of A (its pixel's 32 bytes of
// every chunk) and, for e = t + j THREADS, row e % BN of B in chunk e / BN.
template <int BN> struct Tile {
  static constexpr int PLANES = KCH * CHUNK / GROUP;
  static constexpr int A_PLANE = BM * GROUP;
  static constexpr int B_PLANE = BN * GROUP;
  static constexpr int A_BYTES = PLANES * A_PLANE;
  static constexpr int B_BYTES = PLANES * B_PLANE;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static constexpr int B_ROWS = KCH * BN / THREADS;   // (chunk, B row)s a thread
  static constexpr int ACC = BN / 2;                   // s32 sums an m64 tile
  static constexpr int PITCH = BN + 8;                 // epilogue tile row, ints
  static constexpr int TILE_BYTES = BM * PITCH * 4;
  static_assert(BM == THREADS && BM % 128 == 0, "a row of A a thread");
  static_assert(KCH * BN % THREADS == 0, "whole B rows a thread");
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory of one block");
  static_assert(TILE_BYTES + 2 * BN * 4 + BM * 8 <= SMEM_BYTES, "epilogue tile");
  // descriptor fields are 14 bits in 16-byte units
  static_assert(SMEM_LIMIT / 16 < (1 << 14) && A_PLANE / 16 < (1 << 14),
                "descriptor");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
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
template <int N> __device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, LBO and
// SBO in 16-byte units (14 bits each), layout type 0
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int lbo, int sbo) {
  return uint64_t((addr >> 4) & 0x3FFF) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32);
}

// D (64 x 192, s32, registers) += A (64 x 32, s8, smem) * B^T (192 x 32)
__device__ __forceinline__ void wgmma_n192(int (&d)[96], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 128, s32, registers) += A (64 x 32, s8, smem) * B^T (128 x 32)
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, s32, registers) += A (64 x 32, s8, smem) * B^T (64 x 32)
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[96], uint64_t da, uint64_t db) {
  wgmma_n192(d, da, db);
}
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  wgmma_n128(d, da, db);
}
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  wgmma_n64(d, da, db);
}

// an input coordinate through the border map; -1 where it reads as zero
__device__ __forceinline__ int border_map(int i, int n, int border) {
  if (i >= 0 && i < n) return i;
  if (border == BORDER_REFLECT) return i < 0 ? -i : 2 * n - 2 - i;
  if (border == BORDER_REPLICATE) return i < 0 ? 0 : n - 1;
  return -1;
}

__device__ __forceinline__ float act_scale(const float* amax) {
  return __fdiv_rn(fmaxf(*amax, 1e-12f), 127.f);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const Int8ConvArgs p) {
  using T = Tile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const Int8Phase& ph = p.phase[blockIdx.y];
  const int n_tiles = (p.Co + BN - 1) / BN;
  const int m0 = int(blockIdx.x / n_tiles) * BM;
  const int n0 = int(blockIdx.x % n_tiles) * BN;
  const int M = p.B * ph.hg * ph.wg;
  // this phase's grid is smaller than the launch's: the whole block
  // leaves before its first barrier
  if (m0 >= M) return;
  const int tid = threadIdx.x;
  const int cpt = p.Cp / CHUNK;                 // chunks a tap
  const int chunks = ph.taps * cpt;
  const int n_stages = (chunks + KCH - 1) / KCH;

  // this thread's row of A: output pixel m0 + tid of the phase's grid
  int a_b = -1, a_h = 0, a_w = 0;
  {
    const int m = m0 + tid;
    if (m < M) {
      const int per_img = ph.hg * ph.wg;
      a_b = m / per_img;
      const int r = m - a_b * per_img;
      a_h = (r / ph.wg) * p.stride;
      a_w = (r % ph.wg) * p.stride;
    }
  }

  // K order: the channels in groups of KCH chunks (128 bytes of a pixel;
  // the last group may be shorter), for each group the taps, for each tap
  // the group's chunks. Where C is a multiple of 128 a stage is one tap of
  // one group and the next stage the next tap, whose pixels are those of
  // the stage before, shifted by one (measured 2-4% faster than taps
  // outermost: PERF.md). Chunk q of K is (tap, first channel c0)
  const int full = cpt / KCH, rest = cpt % KCH;  // whole groups, chunks left
  const int per_full = ph.taps * KCH;
  auto chunk_of = [&](int q, int& tap, int& c0) {
    int g, j;
    if (q < full * per_full) {
      g = q / per_full;
      const int r = q - g * per_full;
      tap = r / KCH;
      j = r % KCH;
    } else {
      const int r = q - full * per_full;
      g = full;
      tap = r / rest;
      j = r - tap * rest;
    }
    c0 = (g * KCH + j) * CHUNK;
  };

  // stage s: chunks s * KCH .. + KCH - 1 of K. A chunk past the last (the
  // final stage of a K that is not a multiple of KCH chunks) is
  // zero-filled, so every stage runs the same KCH wgmma steps; rows past
  // M, borders that read as zero and the channels past C (zeros in the
  // codes) likewise
  auto load_stage = [&](int slot, int s) {
    const uint32_t sa = smem_base + slot * T::STAGE_BYTES;
    const uint32_t sb = sa + T::A_BYTES;
#pragma unroll
    for (int k = 0; k < KCH; ++k) {
      const int q = s * KCH + k;
      const bool live = q < chunks;
      int tap = 0, c0 = 0;
      if (live) chunk_of(q, tap, c0);
      const int hi = border_map(a_h + ph.dy[tap], p.H, p.border);
      const int wi = border_map(a_w + ph.dx[tap], p.W, p.border);
      const bool ok = live && a_b >= 0 && hi >= 0 && wi >= 0;
      const int8_t* src = ok ? p.x + ((size_t(a_b) * p.H + hi) * p.W + wi)
                                         * p.Cp + c0
                             : p.x;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        cp_async16(sa + (2 * k + half) * T::A_PLANE + tid * GROUP,
                   src + half * GROUP, ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < T::B_ROWS; ++j) {
      const int e = tid + j * THREADS;
      const int k = e / BN, n = e % BN;
      const int q = s * KCH + k;
      const bool live = q < chunks;
      int tap = 0, c0 = 0;
      if (live) chunk_of(q, tap, c0);
      const int8_t* src = live ? p.w + (size_t(ph.wtap[tap]) * p.COp + n0 + n)
                                           * p.Cp + c0
                               : p.w;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        cp_async16(sb + (2 * k + half) * T::B_PLANE + n * GROUP,
                   src + half * GROUP, live ? 16 : 0);
    }
  };

  // warpgroup wg owns rows 128 wg .. 128 wg + 127: m64 sub-tiles acc[0]
  // and acc[1]
  const int wg = tid / 128;
  int acc[2][T::ACC];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < T::ACC; ++i) acc[u][i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();   // the landed copies, to the tensor cores' proxy
    __syncthreads();       // stage s staged by every thread; s - 1 consumed
    const uint32_t sa = smem_base + (s % STAGES) * T::STAGE_BYTES;
    const uint32_t sb = sa + T::A_BYTES;
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KCH; ++k) {
      // K groups 2k (the descriptor's start) and 2k + 1 (start + LBO) of
      // the chunk; the sub-tiles lie 64 rows (1024 B) apart
      const uint64_t da = make_desc(sa + 2 * k * T::A_PLANE + wg * 128 * GROUP,
                                    T::A_PLANE, 8 * GROUP);
      const uint64_t db = make_desc(sb + 2 * k * T::B_PLANE, T::B_PLANE,
                                    8 * GROUP);
      wgmma_s8(acc[0], da, db);
      wgmma_s8(acc[1], da + 64 * GROUP / 16, db);
    }
    wgmma_commit();
    // stage s + STAGES - 1 loads (into stage s - 1's slot) while the tensor
    // cores run stage s
    if (s + STAGES - 1 < n_stages)
      load_stage((s + STAGES - 1) % STAGES, s + STAGES - 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
  }
  cp_async_wait<0>();
  __syncthreads();   // every warpgroup's wgmma reads are done: reuse smem

  // epilogue, through shared memory. The s32 tile goes to [BM][PITCH]
  // ints: sum i of a sub-tile is row 16 warp + lane / 4 + 8 ((i / 2) % 2),
  // column 8 (i / 4) + 2 (lane % 4) + i % 2 (wgmma's D fragment), stored
  // as pairs; PITCH = BN + 8 puts the 8 rows of a pair store on distinct
  // banks. Each column's s_x * s_w[n] and bias[n] are read once a block,
  // and each row's output offset (-1 past M) is worked out once, by thread
  // row. Then each thread takes runs of 8 columns of one row: float(acc) *
  // (s_x * s_w[n]) + bias[n], one rounding an operation, stored as 16-byte
  // vectors (8 bf16; 8 fp32 or int32 as two) where C_out % 8 == 0
  int* tile = reinterpret_cast<int*>(smem);
  float* col_scale = reinterpret_cast<float*>(smem + T::TILE_BYTES);
  float* col_bias = col_scale + BN;
  long long* row_base = reinterpret_cast<long long*>(col_bias + BN);
  const int lane = tid % 32, warp = (tid % 128) / 32;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < T::ACC; i += 2) {
      const int row = wg * 128 + u * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<uint2*>(tile + row * T::PITCH + col) =
          make_uint2(unsigned(acc[u][i]), unsigned(acc[u][i + 1]));
    }
  if (tid < BN) {
    const int n = n0 + tid;
    const bool dq = n < p.Co && p.out_kind != OUT_ACC;
    const float s_x = dq ? act_scale(p.amax) : 0.f;
    col_scale[tid] = dq ? __fmul_rn(s_x, p.s_w[n]) : 0.f;
    col_bias[tid] = dq && p.bias ? p.bias[n] : 0.f;
  }
  {
    const int m = m0 + tid, per_img = ph.hg * ph.wg;
    const int b = m / per_img, r = m - b * per_img;
    const int oy = (r / ph.wg) * p.ostride + ph.oy0;
    const int ox = (r % ph.wg) * p.ostride + ph.ox0;
    row_base[tid] = m < M ? (((long long)b * p.Ho + oy) * p.Wo + ox) * p.Co : -1;
  }
  __syncthreads();
  const bool vec = p.Co % 8 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  for (int i = tid; i < BM * BN / 8; i += THREADS) {
    const int row = i / (BN / 8), v = i % (BN / 8);
    const int n = n0 + 8 * v;
    if (row_base[row] < 0 || n >= p.Co) continue;
    const size_t base = size_t(row_base[row]) + n;
    const int cnt = p.Co - n < 8 ? p.Co - n : 8;
    const int* a = tile + row * T::PITCH + 8 * v;
    if (p.out_kind == OUT_ACC) {
      int* o = static_cast<int*>(p.out) + base;
      if (vec) {
        reinterpret_cast<uint4*>(o)[0] = reinterpret_cast<const uint4*>(a)[0];
        reinterpret_cast<uint4*>(o)[1] = reinterpret_cast<const uint4*>(a)[1];
      } else {
        for (int e = 0; e < cnt; ++e) o[e] = a[e];
      }
      continue;
    }
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // float(acc) * (s_x * s_w[n]) + bias[n], one rounding an operation
      f[e] = __fmul_rn(__int2float_rn(a[e]), col_scale[8 * v + e]);
      if (p.bias) f[e] = __fadd_rn(f[e], col_bias[8 * v + e]);
    }
    if (p.out_kind == OUT_BF16) {
      bf16* o = static_cast<bf16*>(p.out) + base;
      __align__(16) bf16 h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16_rn(f[e]);
      if (vec) {
        *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(h);
      } else {
        for (int e = 0; e < cnt; ++e) o[e] = h[e];
      }
    } else {
      float* o = static_cast<float*>(p.out) + base;
      if (vec) {
        reinterpret_cast<float4*>(o)[0] = make_float4(f[0], f[1], f[2], f[3]);
        reinterpret_cast<float4*>(o)[1] = make_float4(f[4], f[5], f[6], f[7]);
      } else {
        for (int e = 0; e < cnt; ++e) o[e] = f[e];
      }
    }
  }
}

__device__ __forceinline__ float load_elem(const void* x, int bf16_in, size_t i) {
  return bf16_in ? __bfloat162float(static_cast<const bf16*>(x)[i])
                 : static_cast<const float*>(x)[i];
}

// max |x| over n elements into *amax (zeroed by the launcher): a
// grid-stride loop, a block reduction, one atomicMax on the float's bits
// (non-negative floats order as their bits do; max is exact in any order)
__global__ void __launch_bounds__(QTHREADS)
amax_kernel(const void* x, int bf16_in, long long n, float* amax) {
  __shared__ float red[QTHREADS / 32];
  float m = 0.f;
  const long long step = (long long)gridDim.x * QTHREADS;
  for (long long i = blockIdx.x * (long long)QTHREADS + threadIdx.x; i < n; i += step)
    m = fmaxf(m, fabsf(load_elem(x, bf16_in, size_t(i))));
#pragma unroll
  for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < QTHREADS / 32 ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0)
      atomicMax(reinterpret_cast<unsigned*>(amax), __float_as_uint(m));
  }
}

// x (B, C, H, W) at element strides (sb, sc, sh, sw) -> codes (B, H, W, Cp):
// one thread a pixel's 16-channel group, 16 bytes stored; channels past C
// are zeros. A group of 16 consecutive, 16-byte aligned channels (a
// channels-last input) is read as whole 16-byte vectors.
__global__ void __launch_bounds__(QTHREADS)
quantize_kernel(const void* x, int bf16_in, int B, int C, int H, int W,
                long long sb, long long sc, long long sh, long long sw,
                int Cp, const float* amax, int8_t* out) {
  const int groups = Cp / 16;
  const long long i = blockIdx.x * (long long)QTHREADS + threadIdx.x;
  if (i >= (long long)B * H * W * groups) return;
  const int gq = int(i % groups);
  const long long px = i / groups;
  const int w = int(px % W), h = int((px / W) % H), b = int(px / ((long long)W * H));
  const float s = act_scale(amax);
  const size_t base = size_t(b) * sb + size_t(h) * sh + size_t(w) * sw
                      + size_t(gq) * 16 * sc;
  float v[16];
  const int esize = bf16_in ? 2 : 4;
  const unsigned char* src = static_cast<const unsigned char*>(x) + base * esize;
  if (sc == 1 && gq * 16 + 16 <= C && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(src);
    if (bf16_in) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint4 u = q[k];
        const uint32_t word[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[8 * k + 2 * e] = __uint_as_float(word[e] << 16);
          v[8 * k + 2 * e + 1] = __uint_as_float(word[e] & 0xffff0000u);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 u = q[k];
        v[4 * k] = __uint_as_float(u.x); v[4 * k + 1] = __uint_as_float(u.y);
        v[4 * k + 2] = __uint_as_float(u.z); v[4 * k + 3] = __uint_as_float(u.w);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      v[e] = gq * 16 + e < C ? load_elem(x, bf16_in, base + size_t(e) * sc) : 0.f;
  }
  uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    // round half to even of the quotient, as torch.round (not roundf)
    const float r = rintf(__fdiv_rn(v[e], s));
    const int q = gq * 16 + e < C ? int(fminf(fmaxf(r, -127.f), 127.f)) : 0;
    packed[e / 4] |= uint32_t(q & 0xff) << (8 * (e % 4));
  }
  *reinterpret_cast<uint4*>(out + px * Cp + gq * 16) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

template <int BN>
int launch_conv(const Int8ConvArgs& a, cudaStream_t stream) {
  using T = Tile<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  long long m_tiles = 0;   // the largest phase's
  for (int i = 0; i < a.n_phases; ++i) {
    const long long t = ((long long)a.B * a.phase[i].hg * a.phase[i].wg + BM - 1) / BM;
    if (t > m_tiles) m_tiles = t;
  }
  const long long blocks = m_tiles * ((a.Co + BN - 1) / BN);
  if (blocks < 1 || blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  conv_kernel<BN><<<dim3(unsigned(blocks), unsigned(a.n_phases)), THREADS,
                    T::SMEM_BYTES, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// max |x| of n elements (float32, or bfloat16 with bf16 = 1) into the
// device float *amax. Returns a cudaError_t value (0 on success).
extern "C" int lama_int8_amax(const void* x, int bf16_in, long long n,
                              float* amax, void* stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float), s);
  if (err != cudaSuccess) return int(err);
  long long blocks = (n + QTHREADS - 1) / QTHREADS;
  if (blocks > 4096) blocks = 4096;
  amax_kernel<<<unsigned(blocks), QTHREADS, 0, s>>>(x, bf16_in, n, amax);
  return int(cudaGetLastError());
}

// codes (B, H, W, Cp) of x (B, C, H, W) at element strides (sb, sc, sh, sw)
// with the scale max(*amax, 1e-12) / 127; Cp a multiple of 16, out 16-byte
// aligned.
extern "C" int lama_int8_quantize(const void* x, int bf16_in, int B, int C,
                                  int H, int W, long long sb, long long sc,
                                  long long sh, long long sw, int Cp,
                                  const float* amax, int8_t* out, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || Cp < C || Cp % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return int(cudaErrorInvalidValue);
  const long long threads = (long long)B * H * W * (Cp / 16);
  const long long blocks = (threads + QTHREADS - 1) / QTHREADS;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  quantize_kernel<<<unsigned(blocks), QTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, bf16_in, B, C, H, W, sb, sc, sh, sw, Cp, amax, out);
  return int(cudaGetLastError());
}

// the int8 conv of *a on BM x bn tiles, bn 64 or 128. Returns a cudaError_t
// value (0 on success); the launch is asynchronous on `stream`.
extern "C" int lama_int8_conv(const Int8ConvArgs* a, int bn, void* stream) {
  if (a->Cp % CHUNK || a->COp % COP_ALIGN || a->COp < a->Co || a->n_phases < 1 ||
      a->n_phases > MAX_PHASES || a->out_kind < OUT_FP32 || a->out_kind > OUT_ACC ||
      a->border < BORDER_ZERO || a->border > BORDER_REPLICATE ||
      reinterpret_cast<uintptr_t>(a->x) % 16 || reinterpret_cast<uintptr_t>(a->w) % 16)
    return int(cudaErrorInvalidValue);
  for (int i = 0; i < a->n_phases; ++i)
    if (a->phase[i].taps < 1 || a->phase[i].taps > MAX_TAPS)
      return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if ((a->Co + bn - 1) / bn * bn > a->COp) return int(cudaErrorInvalidValue);
  if (bn == 64) return launch_conv<64>(*a, s);
  if (bn == 128) return launch_conv<128>(*a, s);
  if (bn == 192) return launch_conv<192>(*a, s);
  return int(cudaErrorInvalidValue);
}
