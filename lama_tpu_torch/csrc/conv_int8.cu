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
//                    mma.sync.m16n8k32 s8 x s8 -> s32, the sums in int32
//                    registers; epilogue float(acc) * (s_x * s_w[n]) +
//                    bias[n] in fp32, rounded once per operation as
//                    lama_tpu's dequantize is, then stored NHWC (the
//                    channels-last layout the next layer reads) as fp32 or
//                    bf16, or the raw int32 sums (the card's exactness
//                    check).
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
// per product. The design is a plain multi-stage mma.sync GEMM, right
// before fast: 128 x BN tiles (BN 128, or 64 for narrow outputs), 8 warps
// of 32 x BN/2, a 4-deep cp.async ring of 64-byte K stages (two 32-channel
// chunks, each one tap), 48-byte shared rows so ldmatrix reads are free
// of bank conflicts, one block tile per (pixel tile, channel tile) with
// the channel tiles of one pixel tile adjacent in the grid (they share its
// codes in L2). int8 wgmma, a persistent grid and folding the quantize
// pass into the previous layer's epilogue are later work.
//
// Measured (chip_smoke.py phase 16, NVIDIA H100 80GB HBM3 at 700 W): the
// GEMM alone at b16 takes 0.22 ms device for l2g (14% of the int8 peak)
// and 0.86 ms for the 512 -> 512 block conv (18%), where the bf16 wgmma
// conv takes 0.10 and 0.45; a calibrated int8 forward of big-lama is 25%
// slower than its bf16 one (PERF.md).

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

constexpr int THREADS = 256;     // 8 warps: 4 along M x 2 along N
constexpr int BM = 128;          // output pixels a block tile
constexpr int CHUNK = 32;        // input channels (bytes) a K chunk
constexpr int KCH = 2;           // chunks a pipeline stage
constexpr int ROW = 48;          // shared bytes a 32-byte chunk row
constexpr int STAGES = 4;        // pipeline ring depth
constexpr int COP_ALIGN = 128;   // the packed weight's C_out padding
constexpr int QTHREADS = 256;    // quantize_kernel / amax_kernel blocks

template <int BN> struct Tile {
  static constexpr int WN = BN / 2;             // a warp's columns
  static constexpr int MT = 2;                  // m16 tiles a warp (32 rows)
  static constexpr int NT = WN / 8;             // n8 tiles a warp
  static constexpr int A_BYTES = KCH * BM * ROW;
  static constexpr int B_BYTES = KCH * BN * ROW;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static constexpr int A_COPIES = KCH * BM * 2 / THREADS;   // 16-byte copies
  static constexpr int B_COPIES = KCH * BN * 2 / THREADS;
  static_assert(NT % 2 == 0, "ldmatrix.x4 loads two n8 tiles");
  static_assert(KCH * BM * 2 % THREADS == 0 && KCH * BN * 2 % THREADS == 0,
                "whole copies a thread");
  static_assert(COP_ALIGN % BN == 0, "channel tiles inside the padding");
};

// rows 8 apart in shared memory fall on distinct 16-byte bank groups, so an
// 8 x 16-byte ldmatrix phase is conflict-free
static_assert((ROW / 16) % 2 == 1 && ROW % 16 == 0 && ROW >= CHUNK,
              "ldmatrix rows on distinct bank groups");

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
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
__global__ void __launch_bounds__(THREADS, 2)
conv_kernel(const Int8ConvArgs p) {
  using T = Tile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const Int8Phase& ph = p.phase[blockIdx.y];
  const int n_tiles = (p.Co + BN - 1) / BN;
  const int m0 = int(blockIdx.x / n_tiles) * BM;
  const int n0 = int(blockIdx.x % n_tiles) * BN;
  const int M = p.B * ph.hg * ph.wg;
  if (m0 >= M) return;   // this phase's grid is smaller than the launch's
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cpt = p.Cp / CHUNK;                 // chunks a tap
  const int chunks = ph.taps * cpt;
  const int n_stages = (chunks + KCH - 1) / KCH;

  // this thread's copies: A rows (tid / 4) + 64 q, B rows (tid / 4) + 64 q;
  // chunk kc = (tid % 4) / 2 of a stage, 16-byte half tid % 2
  const int kc = (tid % 4) / 2, half = tid % 2;
  int a_b[T::A_COPIES], a_h[T::A_COPIES], a_w[T::A_COPIES];
#pragma unroll
  for (int q = 0; q < T::A_COPIES; ++q) {
    const int m = m0 + tid / 4 + q * (THREADS / 4);
    if (m < M) {
      const int per_img = ph.hg * ph.wg;
      a_b[q] = m / per_img;
      const int r = m - a_b[q] * per_img;
      a_h[q] = (r / ph.wg) * p.stride;
      a_w[q] = (r % ph.wg) * p.stride;
    } else {
      a_b[q] = -1;
      a_h[q] = a_w[q] = 0;
    }
  }

  auto load_stage = [&](int slot, int s) {
    const uint32_t sa = smem_base + slot * T::STAGE_BYTES;
    const uint32_t sb = sa + T::A_BYTES;
    const int q_chunk = s * KCH + kc;
    const bool live = q_chunk < chunks;
    const int tap = live ? q_chunk / cpt : 0;
    const int c0 = live ? (q_chunk - tap * cpt) * CHUNK + half * 16 : 0;
    const int dy = ph.dy[tap], dx = ph.dx[tap];
#pragma unroll
    for (int q = 0; q < T::A_COPIES; ++q) {
      const int row = tid / 4 + q * (THREADS / 4);
      const uint32_t dst = sa + (kc * BM + row) * ROW + half * 16;
      const int hi = border_map(a_h[q] + dy, p.H, p.border);
      const int wi = border_map(a_w[q] + dx, p.W, p.border);
      const bool ok = live && a_b[q] >= 0 && hi >= 0 && wi >= 0;
      const int8_t* src = ok ? p.x + ((size_t(a_b[q]) * p.H + hi) * p.W + wi)
                                         * p.Cp + c0
                             : p.x;
      cp_async16(dst, src, ok ? 16 : 0);
    }
    const int wt = ph.wtap[tap];
#pragma unroll
    for (int q = 0; q < T::B_COPIES; ++q) {
      const int row = tid / 4 + q * (THREADS / 4);
      const uint32_t dst = sb + (kc * BN + row) * ROW + half * 16;
      const int8_t* src = live ? p.w + (size_t(wt) * p.COp + n0 + row) * p.Cp + c0
                               : p.w;
      cp_async16(dst, src, live ? 16 : 0);
    }
  };

  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix lane addresses: A matrix j = lane / 8 is rows (j % 2) * 8 ..
  // + 7 at bytes (j / 2) * 16 (a0..a3 of m16n8k32); B matrix j is n rows
  // (j / 2) * 8 .. + 7 at bytes (j % 2) * 16 (b0, b1 of two n8 tiles)
  const int warp_m = warp % 4, warp_n = warp / 4;
  const int lr = lane % 8, lj = lane / 8;
  const uint32_t a_off = (warp_m * 32 + (lj % 2) * 8 + lr) * ROW + (lj / 2) * 16;
  const uint32_t b_off = (warp_n * T::WN + (lj / 2) * 8 + lr) * ROW + (lj % 2) * 16;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage s landed for all; stage s - 1 consumed
    if (s + STAGES - 1 < n_stages) load_stage((s + STAGES - 1) % STAGES, s + STAGES - 1);
    cp_async_commit();
    const uint32_t sa = smem_base + (s % STAGES) * T::STAGE_BYTES;
    const uint32_t sb = sa + T::A_BYTES;
#pragma unroll
    for (int k = 0; k < KCH; ++k) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
        ldmatrix_x4(a[i], sa + (k * BM + i * 16) * ROW + a_off);
#pragma unroll
      for (int j = 0; j < T::NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, sb + (k * BN + j * 8) * ROW + b_off);
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma_s8(acc[i][j], a[i], b[0], b[1]);
          mma_s8(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at row g, columns 2 t, 2 t + 1; c2, c3 at row g + 8
  const int g = lane / 4, t = lane % 4;
  const float s_x = p.out_kind == OUT_ACC ? 0.f : act_scale(p.amax);
  const bool pair = p.Co % 2 == 0;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + warp_m * 32 + i * 16 + g + hr * 8;
      if (m >= M) continue;
      const int per_img = ph.hg * ph.wg;
      const int b = m / per_img, r = m - b * per_img;
      const int oy = (r / ph.wg) * p.ostride + ph.oy0;
      const int ox = (r % ph.wg) * p.ostride + ph.ox0;
      const size_t base = ((size_t(b) * p.Ho + oy) * p.Wo + ox) * p.Co;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int n = n0 + warp_n * T::WN + j * 8 + 2 * t;
        if (n >= p.Co) continue;
        const int v0 = acc[i][j][2 * hr], v1 = acc[i][j][2 * hr + 1];
        const bool two = n + 1 < p.Co;
        if (p.out_kind == OUT_ACC) {
          int* o = static_cast<int*>(p.out) + base + n;
          if (two && pair) { *reinterpret_cast<int2*>(o) = make_int2(v0, v1); }
          else { o[0] = v0; if (two) o[1] = v1; }
          continue;
        }
        // float(acc) * (s_x * s_w[n]) + bias[n], one rounding an operation
        float f0 = __fmul_rn(__int2float_rn(v0), __fmul_rn(s_x, p.s_w[n]));
        float f1 = two ? __fmul_rn(__int2float_rn(v1), __fmul_rn(s_x, p.s_w[n + 1])) : 0.f;
        if (p.bias) {
          f0 = __fadd_rn(f0, p.bias[n]);
          if (two) f1 = __fadd_rn(f1, p.bias[n + 1]);
        }
        if (p.out_kind == OUT_BF16) {
          bf16* o = static_cast<bf16*>(p.out) + base + n;
          if (two && pair) {
            __nv_bfloat162 v;
            v.x = __float2bfloat16_rn(f0);
            v.y = __float2bfloat16_rn(f1);
            *reinterpret_cast<__nv_bfloat162*>(o) = v;
          } else {
            o[0] = __float2bfloat16_rn(f0);
            if (two) o[1] = __float2bfloat16_rn(f1);
          }
        } else {
          float* o = static_cast<float*>(p.out) + base + n;
          if (two && pair) { *reinterpret_cast<float2*>(o) = make_float2(f0, f1); }
          else { o[0] = f0; if (two) o[1] = f1; }
        }
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
  if (bn == 64) return launch_conv<64>(*a, s);
  if (bn == 128) return launch_conv<128>(*a, s);
  return int(cudaErrorInvalidValue);
}
