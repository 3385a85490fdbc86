// The generators' 7x7 stem for Hopper (sm_90a): reflect pad 3, then a 7x7
// stride-1 conv of C <= 8 input channels into C_out <= 64 output channels
// (a multiple of 16), NHWC in and out, float32 or bfloat16. Bound to Python
// through the extern "C" launcher at the bottom (ctypes; see
// lama_tpu_torch/ops/kernels/stem_conv.py, whose constants, weight packing
// and bf16 fragment map mirror this file's).
//
// Replaces, inside that envelope, the TPU kernel lama_tpu/ops/pallas/
// halo_conv.py::halo_conv_reflect_tiled (:158) at k = 7, s = 1, which is
// what lama_tpu/ops/conv.py::conv2d (:200) computes for the JAX generators'
// stem: big-lama's 4 -> 64 without bias, big-lama-regular's with one.
// Kernel 7's other shapes (k = 3, stride 2, wider C) stay on
// csrc/halo_conv.cu. The reflect halo is built on chip (torch 'reflect':
// row -1 reads row 1, row H reads row H - 2); no padded tensor reaches HBM.
//
// Bound: 2 * 49 * C * C_out FLOP per output pixel against C values read
// and C_out written. At (16, 4, 512, 512) -> 64 that is 105 GFLOP against
// 1.14 GB in fp32 and 0.57 GB in bf16. fp32 on the SIMT FMA units (67
// TFLOP/s) is FMA-bound (1.57 ms of FLOP, 0.34 ms of bytes); bf16 on the
// tensor cores (989 TFLOP/s) is bound by its bytes, nearly all of them the
// output (0.17 ms against 0.11 ms of FLOP).
//
// One skeleton for both precisions:
//   * A persistent 1-D grid: min(tiles, SMs x MIN_BLOCKS) blocks, each
//     walking output tiles t = blockIdx.x, + gridDim.x, ... A tile is
//     TILE_H x TILE_W = 8 x 32 output pixels of one image, all C_out
//     channels (padded to CO_MAX = 64 in the packed weights).
//   * The packed weights (and the bias, zero-filled past C_out) are staged
//     in shared memory once per block, not per tile: one flat run of
//     16-byte cp.async copies of the image the wrapper packs.
//   * A ring of RING = 2 halo stages: tile i + 1's reflect-mapped 14 x 39
//     halo loads by cp.async while tile i computes. A halo pixel holds
//     PITCH = 4 channels (C <= 4) or 8 (C 5..8), zero-filled past C; where
//     C == PITCH and x is 16-byte aligned a pixel is one copy (fp32: 16
//     bytes, or two at pitch 8; bf16: 8 bytes, or 16 at pitch 8), else
//     the pixel is staged with plain element loads. The halo's last
//     column is an extra pixel of zeros, which only the bf16 k padding
//     reads (below).
//   * The epilogue adds the bias and writes each pixel's channels as
//     16-byte stores (fp32 from registers, bf16 through a per-warp staging
//     buffer, since an mma accumulator holds two channels of a pixel).
//
// fp32 (full FFMA, no TF32, no mma): a thread owns 8 consecutive pixels of
// one output row and 8 output channels (cg * 4 + 0..3 and 32 + cg * 4 +
// 0..3): 64 accumulators. For each ky and 4-channel quad it loads the 14
// halo pixels its 8 pixels read across the 7 kx taps once (14 LDS.128) and
// reuses each for up to 7 taps; the weights are float4 broadcasts. Per ky
// and quad: 70 LDS.128 per 1792 FFMA. Lane l of warp w has channel group
// cg = l % 8 and output row (w % 2) * 4 + l / 8, column run (w / 2) * 8: a
// warp's B loads are 8 consecutive 16-byte vectors, its A loads four
// broadcasts on four consecutive halo rows, which the static_assert below
// puts on four distinct 16-byte bank groups: one wavefront a load.
//
// bf16: mma.sync.aligned.m16n8k16 (bf16 operands, fp32 accumulation). Warp
// w owns output row w of the tile, two m-tiles of 16 pixels (columns 0-15,
// 16-31) x 8 n-tiles of 8 channels: 64 accumulators a lane. K is (ky, kx,
// c): for a fixed ky the 7 * PITCH values (kx, c) of output pixel m are
// contiguous in the NHWC halo row from pixel m on, so there is no im2col:
// each A register is one 32-bit load at halo_row(row + ky) + m * PITCH +
// k. Each ky's 7 * PITCH is padded to KY = 32 (pitch 4) or 64 (pitch 8)
// with zero weights; the padded k slots read up to pixel m + 7, which is
// why the halo has its extra zero column (0 x NaN would be NaN). B comes
// from the weights staged as [n][ky * KY + k] with a row pitch that keeps
// a warp's 32-bit loads on 32 distinct banks (static_assert).
//
// No backward kernel: the TPU kernel has none; the port's autograd wrapper
// takes the plain version's VJP.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int KS = 7, PAD = 3;             // kernel size, reflect pad
constexpr int TILE_H = 8, TILE_W = 32;     // output pixels per tile (256)
constexpr int THREADS = 256;
constexpr int CO_MAX = 64;                 // output channels per tile
constexpr int RING = 2;                    // halo stages
constexpr int HALO_H = TILE_H + KS - 1;    // 14
constexpr int HALO_W = TILE_W + KS;        // 39: 38 + one extra zero pixel
constexpr int HALO_PIX = HALO_H * HALO_W;
constexpr int HALO_PER_THREAD = (HALO_PIX + THREADS - 1) / THREADS;
constexpr int BIAS_BYTES = CO_MAX * 4;
constexpr int SMEM_LIMIT = 232448;         // shared memory of one block
constexpr int MAX_DEVICES = 64;
static_assert(TILE_H == 8 && TILE_W == 32 && THREADS == 256 && CO_MAX == 64,
              "fp32: 32 pixel runs of 8 x 8 channel groups; bf16: a warp "
              "per output row, two m-tiles, eight n-tiles");

// the warp's four halo-row addresses, `units` 16-byte units apart, fall on
// four distinct 16-byte bank groups (8 per 128-byte bank row)
constexpr bool distinct_bank_groups(int units) {
  return (units % 8) % 2 == 1 || units % 8 == 2 || units % 8 == 6;
}

// The plan of one instance: T float or bf16, PITCH 4 or 8 channels a pixel.
template <typename T, int PITCH> struct Plan {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int ROW = HALO_W * PITCH;                 // elements a halo row
  static constexpr int HALO_BYTES = (HALO_H * ROW * int(sizeof(T)) + 15) / 16 * 16;
  static constexpr int PIX_BYTES = PITCH * int(sizeof(T));   // a halo pixel
  static constexpr int COPY = PIX_BYTES < 16 ? PIX_BYTES : 16;
  static constexpr int COPIES = PIX_BYTES / COPY;            // copies a pixel
  // bf16: k per ky (7 * PITCH padded to 16) and the weight row pitch of one
  // output channel, + 8 so that 8 rows fall on 8 distinct bank groups
  static constexpr int KY = (KS * PITCH + 15) / 16 * 16;
  static constexpr int WPITCH = KS * KY + 8;
  static constexpr int WEIGHT_BYTES = BF16 ? CO_MAX * WPITCH * 2
                                           : KS * KS * PITCH * CO_MAX * 4;
  static constexpr int STAGE_PITCH = CO_MAX + 8;             // bf16 epilogue
  static constexpr int STAGE_BYTES = BF16 ? THREADS * STAGE_PITCH * 2 : 0;
  static constexpr int HALO_OFFSET = WEIGHT_BYTES + BIAS_BYTES;
  static constexpr int STAGE_OFFSET = HALO_OFFSET + RING * HALO_BYTES;
  static constexpr int SMEM_BYTES = STAGE_OFFSET + STAGE_BYTES;
  // fp32 needs more than 128 registers a thread: one block of 8 warps a SM
  static constexpr int MIN_BLOCKS = BF16 ? 2 : 1;
  static_assert(PITCH == 4 || PITCH == 8, "pitch");
  static_assert(WEIGHT_BYTES % 16 == 0 && (ROW * int(sizeof(T))) % 4 == 0,
                "16-byte weight copies, 32-bit A loads");
  static_assert(BF16 || distinct_bank_groups(ROW / 4), "fp32 A bank conflict");
  static_assert(!BF16 || (WPITCH / 2) % 8 == 4, "bf16 B bank conflict");
  static_assert((STAGE_PITCH * 2) % 16 == 0 && (STAGE_PITCH / 2) % 32 == 4,
                "bf16 staging: 16-byte rows, conflict-free 32-bit writes");
  static_assert(KS * PITCH <= KY && (KY - 1) / PITCH <= KS,
                "padded k slots read at most one pixel past the 7 taps");
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory of one block");
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// torch 'reflect' index for |overhang| < n; the clamp only matters for halo
// rows/cols of a partial edge tile whose outputs are never stored.
__device__ __forceinline__ int reflect_idx(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// asynchronous global -> shared copies; `bytes` below the copy's size
// zero-fills the rest (0: all zeros, the source is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed copy groups are pending
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += a * b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), d 16 x 8 fp32, in the PTX fragment layouts of m16n8k16
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf16 l = __float2bfloat16(lo), h = __float2bfloat16(hi);
  return uint32_t(reinterpret_cast<const uint16_t&>(l)) |
         (uint32_t(reinterpret_cast<const uint16_t&>(h)) << 16);
}

// fp32: acc[p][j] += the thread's 8 pixels x 8 channels over all 49 taps.
// hp: the halo at the thread's first pixel, tap (0, 0); wp: the staged
// weights [ky][kx][c][CO_MAX] + cg * 4.
template <int PITCH>
__device__ __forceinline__ void fma_tile(float (&acc)[8][8], const float* hp,
                                         const float* wp) {
  constexpr int ROW = Plan<float, PITCH>::ROW;
#pragma unroll 1
  for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
    for (int cq = 0; cq < PITCH / 4; ++cq) {
      float4 a[8 + KS - 1];
#pragma unroll
      for (int j = 0; j < 8 + KS - 1; ++j)
        a[j] = *reinterpret_cast<const float4*>(hp + ky * ROW + j * PITCH + cq * 4);
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* w = wp + ((ky * KS + kx) * PITCH + cq * 4 + e) * CO_MAX;
          const float4 b0 = *reinterpret_cast<const float4*>(w);
          const float4 b1 = *reinterpret_cast<const float4*>(w + 32);
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const float4& v = a[p + kx];
            const float av = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
            acc[p][0] += av * b0.x; acc[p][1] += av * b0.y;
            acc[p][2] += av * b0.z; acc[p][3] += av * b0.w;
            acc[p][4] += av * b1.x; acc[p][5] += av * b1.y;
            acc[p][6] += av * b1.z; acc[p][7] += av * b1.w;
          }
        }
      }
    }
  }
}

// bf16: acc[mt][j] += m-tile mt (16 pixels) x n-tile j (8 channels) over
// K = 7 ky rows of KY. hrow: the halo row of the warp's output row (ky 0);
// wsm: the staged weights [n][WPITCH].
template <int PITCH>
__device__ __forceinline__ void mma_tile(float (&acc)[2][8][4], const bf16* hrow,
                                         const bf16* wsm, int lane) {
  using PL = Plan<bf16, PITCH>;
  const int g = lane >> 2, t = lane & 3;
  // lane (g, t): A rows g and g + 8, k 2t, 2t + 1 (+ 8); B column g, k the same
  const bf16* hb = hrow + g * PITCH + 2 * t;
  const bf16* wb = wsm + g * PL::WPITCH + 2 * t;
#pragma unroll 1
  for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
    for (int s = 0; s < PL::KY / 16; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ap = hb + ky * PL::ROW + mt * 16 * PITCH + 16 * s;
        a[mt][0] = ld32(ap);
        a[mt][1] = ld32(ap + 8 * PITCH);
        a[mt][2] = ld32(ap + 8);
        a[mt][3] = ld32(ap + 8 * PITCH + 8);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* bp = wb + j * 8 * PL::WPITCH + ky * PL::KY + 16 * s;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
        mma_bf16(acc[0][j], a[0], b0, b1);
        mma_bf16(acc[1][j], a[1], b0, b1);
      }
    }
  }
}

// x: (B, H, W, C) NHWC; wpk: the packed weights (stem_conv.py::
// pack_weight), 16-byte aligned; bias: (Co,) fp32 or null; out: (B, H, W,
// Co) NHWC, 16-byte aligned. vec: C == PITCH and x 16-byte aligned.
template <typename T, int PITCH>
__global__ void __launch_bounds__(THREADS, Plan<T, PITCH>::MIN_BLOCKS)
stem_conv_kernel(const T* __restrict__ x, const T* __restrict__ wpk,
                 const float* __restrict__ bias, T* __restrict__ out, int B,
                 int H, int W, int C, int Co, int vec) {
  using PL = Plan<T, PITCH>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles_img = ((H + TILE_H - 1) / TILE_H) * tiles_w;
  const int tiles = B * tiles_img;
  const T zero = from_f<T>(0.f);

  // once per block: the weights (cp.async) and the bias (zero past Co)
  for (int i = tid; i < PL::WEIGHT_BYTES / 16; i += THREADS)
    cp_async16(smem_base + 16 * i, reinterpret_cast<const unsigned char*>(wpk) + 16 * i, 16);
  float* bsm = reinterpret_cast<float*>(smem + PL::WEIGHT_BYTES);
  for (int n = tid; n < CO_MAX; n += THREADS)
    bsm[n] = bias && n < Co ? bias[n] : 0.f;

  // tile t's halo into ring stage `stage`: halo pixel (hr, hc) is input
  // pixel (reflect(r0 - 3 + hr), reflect(c0 - 3 + hc)), the last column
  // zeros
  auto load_halo = [&](int stage, int t) {
    const int b = t / tiles_img, rem = t % tiles_img;
    const int r0 = (rem / tiles_w) * TILE_H - PAD, c0 = (rem % tiles_w) * TILE_W - PAD;
    const T* xb = x + size_t(b) * H * W * C;
    const uint32_t dst = smem_base + PL::HALO_OFFSET + stage * PL::HALO_BYTES;
    T* hs = reinterpret_cast<T*>(smem + PL::HALO_OFFSET + stage * PL::HALO_BYTES);
#pragma unroll
    for (int q = 0; q < HALO_PER_THREAD; ++q) {
      const int i = tid + q * THREADS;
      if (i >= HALO_PIX) break;
      const int hr = i / HALO_W, hc = i % HALO_W;
      const bool real = hc < HALO_W - 1;
      const T* src = xb + (size_t(reflect_idx(r0 + hr, H)) * W
                           + reflect_idx(c0 + hc, W)) * C;
      if (vec) {
#pragma unroll
        for (int e = 0; e < PL::COPIES; ++e) {
          const uint32_t d = dst + i * PL::PIX_BYTES + e * PL::COPY;
          const void* s = real ? reinterpret_cast<const unsigned char*>(src) + e * PL::COPY
                               : static_cast<const void*>(x);
          if (PL::COPY == 16) cp_async16(d, s, real ? 16 : 0);
          else cp_async8(d, s, real ? 8 : 0);
        }
      } else {
#pragma unroll
        for (int c = 0; c < PITCH; ++c)
          hs[i * PITCH + c] = real && c < C ? src[c] : zero;
      }
    }
  };

  int t = blockIdx.x;
  load_halo(0, t);
  cp_async_commit();
  for (int i = 0; t < tiles; ++i, t += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();   // tile t staged by every thread; tile t - grid consumed
    if (t + int(gridDim.x) < tiles) load_halo((i + 1) % RING, t + gridDim.x);
    cp_async_commit();
    const int b = t / tiles_img, rem = t % tiles_img;
    const int r0 = (rem / tiles_w) * TILE_H, c0 = (rem % tiles_w) * TILE_W;
    const T* halo = reinterpret_cast<const T*>(
        smem + PL::HALO_OFFSET + (i % RING) * PL::HALO_BYTES);
    if constexpr (PL::BF16) {
      float acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
      mma_tile<PITCH>(acc, halo + warp * PL::ROW, reinterpret_cast<const bf16*>(smem), lane);
      // the accumulators + bias as bf16 pairs into the warp's staging rows
      // (pixel mt * 16 + g (+ 8), channels 8j + 2t, + 1), then each pixel's
      // channels out as 16-byte stores
      bf16* st = reinterpret_cast<bf16*>(smem + PL::STAGE_OFFSET)
                 + warp * 32 * PL::STAGE_PITCH;
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * tq;
        const float2 bv = *reinterpret_cast<const float2*>(bsm + n);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int px = mt * 16 + g + 8 * h;
            *reinterpret_cast<uint32_t*>(st + px * PL::STAGE_PITCH + n) =
                pack_bf16(acc[mt][j][2 * h] + bv.x, acc[mt][j][2 * h + 1] + bv.y);
          }
      }
      __syncwarp();
      const int row = r0 + warp;
      if (row < H) {
#pragma unroll
        for (int it = 0; it < 32 * CO_MAX / 8 / 32; ++it) {
          const int v = lane + 32 * it, px = v / (CO_MAX / 8), n = (v % (CO_MAX / 8)) * 8;
          const int col = c0 + px;
          if (col < W && n < Co)
            *reinterpret_cast<uint4*>(out + ((size_t(b) * H + row) * W + col) * Co + n) =
                *reinterpret_cast<const uint4*>(st + px * PL::STAGE_PITCH + n);
        }
      }
    } else {
      const int cg = lane % 8;
      const int prow = (warp % 2) * 4 + lane / 8, pcol = (warp / 2) * 8;
      float acc[8][8];
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;
      fma_tile<PITCH>(acc, reinterpret_cast<const float*>(halo) + prow * PL::ROW + pcol * PITCH,
                      reinterpret_cast<const float*>(smem) + cg * 4);
      const int row = r0 + prow;
      if (row < H) {
        const float4 bv0 = *reinterpret_cast<const float4*>(bsm + cg * 4);
        const float4 bv1 = *reinterpret_cast<const float4*>(bsm + 32 + cg * 4);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int col = c0 + pcol + p;
          if (col >= W) break;
          float* o = reinterpret_cast<float*>(out) + ((size_t(b) * H + row) * W + col) * Co;
          if (cg * 4 < Co)
            *reinterpret_cast<float4*>(o + cg * 4) = make_float4(
                acc[p][0] + bv0.x, acc[p][1] + bv0.y, acc[p][2] + bv0.z, acc[p][3] + bv0.w);
          if (32 + cg * 4 < Co)
            *reinterpret_cast<float4*>(o + 32 + cg * 4) = make_float4(
                acc[p][4] + bv1.x, acc[p][5] + bv1.y, acc[p][6] + bv1.z, acc[p][7] + bv1.w);
        }
      }
    }
  }
}

// SMs of the current device (the persistent grid's size), read once per
// device
int sm_count() {
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 0;
  if (!cached[dev]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess)
      return 0;
    cached[dev] = n;
  }
  return cached[dev];
}

template <typename T, int PITCH>
int launch(const void* x, const void* wpk, const void* bias, void* out, int B,
           int H, int W, int C, int Co, cudaStream_t stream) {
  using PL = Plan<T, PITCH>;
  const long long tiles = (long long)B * ((H + TILE_H - 1) / TILE_H)
                          * ((W + TILE_W - 1) / TILE_W);
  const int sms = sm_count();
  if (tiles > 0x7fffffffLL || sms < 1) return int(cudaErrorInvalidValue);
  const int vec = C == PITCH && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel<T, PITCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PL::SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  const long long cap = (long long)sms * PL::MIN_BLOCKS;
  const unsigned grid = unsigned(tiles < cap ? tiles : cap);
  stem_conv_kernel<T, PITCH><<<grid, THREADS, PL::SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wpk),
      static_cast<const float*>(bias), static_cast<T*>(out), B, H, W, C, Co,
      vec);
  return int(cudaGetLastError());
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16. x: (B, H, W, C) NHWC in that type,
// 1 <= C <= 8; wpk: stem_conv.py::pack_weight's image for that type and
// pitch (4 for C <= 4, else 8), 16-byte aligned; bias: (Co,) fp32 or null;
// out: (B, H, W, Co) NHWC in x's type, 16-byte aligned, Co a multiple of
// 16 up to 64; H, W > 3. Returns a cudaError_t value (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int lama_stem_conv(const void* x, const void* wpk, const void* bias,
                              void* out, int B, int H, int W, int C, int Co,
                              int dtype, void* stream) {
  if (B < 1 || C < 1 || C > 8 || Co < 16 || Co > CO_MAX || Co % 16 ||
      H <= PAD || W <= PAD || reinterpret_cast<uintptr_t>(wpk) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (C <= 4)
    return dtype ? launch<bf16, 4>(x, wpk, bias, out, B, H, W, C, Co, s)
                 : launch<float, 4>(x, wpk, bias, out, B, H, W, C, Co, s);
  return dtype ? launch<bf16, 8>(x, wpk, bias, out, B, H, W, C, Co, s)
               : launch<float, 8>(x, wpk, bias, out, B, H, W, C, Co, s);
}
