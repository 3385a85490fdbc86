// Reflect-padded convolutions for the FFC generator, hand-written for Hopper
// (sm_90a). Bound to Python through the extern "C" launchers at the bottom
// (ctypes; see lama_tpu_torch/ops/kernels/reflect_conv.py).
//
// Replaces the TPU kernels of lama_tpu/ops/pallas/reflect_conv.py:
//   reflect_conv3x3_cols  (3x3, C = C_out = 128; the 36 l2l convs)
//   reflect_conv3x3_taps  (3x3, C and C_out multiples of 128; l2g and g2l)
//   reflect_out_conv7x7   (7x7, C_out <= 8; the 64->3 RGB head)
// in float32, and the head in bfloat16 too. The two 3x3 convs in bfloat16
// are the wgmma implicit GEMM of csrc/conv3x3_wgmma.cu; their launchers
// here refuse dtype 1. The fourth, reflect_down_conv3x3 (3x3 stride 2, the
// four downsamples), is csrc/conv3x3_simt.cu's stride-2 form in float32 and
// conv3x3_wgmma.cu's in bfloat16.
//
// What the TPU kernels keep out of HBM, these keep out too: the reflect
// halo is built while the input tile is copied into shared memory (torch
// 'reflect': row -1 reads row 1, row H reads row H-2), so no padded tensor
// is ever written. Layout is channels-last (NHWC) throughout: one output
// pixel's input channels are contiguous, so a halo pixel is one 16-byte
// vector load per 4 (fp32) or 8 (bf16) channels.
//
// 3x3 kernel (conv3x3_kernel, fp32): an implicit GEMM per block over an
// 8x16 output-pixel tile (M = 128) and 128 output channels (N), with K = 9
// taps x C input channels walked in chunks of CK = 16 channels. Each chunk
// stages the input halo tile and the chunk's 9 x CK x 128 weights in shared
// memory (weights in [tap][ci][co] order, the order the loop reads). The
// nine tap windows are read straight off the 10 x 18 halo tile: for tap
// (ky, kx) the output pixel (row, j) reads halo[(row + ky) * 18 + j + kx].
// So the TPU's two variants (im2col GEMM and nine per-tap GEMMs, Mosaic
// layout choices) are two instantiations of one kernel here: cols fixes
// C = 128 at compile time (CFIX), so its whole K = 9 x 128 walk and the
// pixel stride are constants; taps takes C at run time (CFIX = 0).
// Arithmetic: full-precision FMA (no TF32), each thread an 8-pixel x
// 8-channel register tile.
// Bound: at the bottleneck shape (B,64,64,128)->384 the work is 2*9*C*Co
// FLOP per pixel against (C + Co) * 4 bytes in and out, ~500 FLOP/byte, so
// the FMA units. The halo tile is loaded once per 9 taps, which is what
// keeps the operand traffic in shared memory rather than L2.
//
// 7x7 head (conv7_thin_kernel): C_out = 3 wastes any GEMM tile, so each
// thread owns one column of R = 4 output pixels and all C_out channels
// (R * C_out accumulators) and walks a register strip of R + 6 input rows
// per (channel, kx), reusing each loaded value for all 7 ky taps. The halo
// tile (16+6) x (64+6) per 8-channel chunk lives in shared memory as fp32
// channel planes, so a warp reads 32 consecutive columns without bank
// conflicts; weights sit in [ci][kx][ky][co] order. Bound: 49 * C * C_out
// FMA per pixel against C inputs read once, FMA-bound on the SIMT units.
//
// No backward kernels: the TPU kernels have none either (their custom_vjp
// takes the VJP of the plain reflect pad + conv), and the port does the
// same in a torch.autograd.Function.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

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

// ---------------------------------------------------------------- 3x3
constexpr int C3_TH = 8, C3_TW = 16, C3_BN = 128, C3_THREADS = 256;
constexpr int C3_HR = C3_TH + 2, C3_HC = C3_TW + 2;   // halo tile

// float32 only (the bf16 3x3 convs are conv3x3_wgmma.cu's)
template <typename T> struct Conv3Cfg;
template <> struct Conv3Cfg<float> {
  static constexpr int CK = 16;          // input channels per chunk
  static constexpr int CKP = CK + 4;     // halo pixel pitch (16-B aligned)
  static constexpr int BNP = C3_BN + 4;  // weight row pitch
};

template <typename T>
constexpr size_t conv3_smem_bytes() {
  return sizeof(T) * (size_t(C3_HR) * C3_HC * Conv3Cfg<T>::CKP +
                      size_t(9) * Conv3Cfg<T>::CK * Conv3Cfg<T>::BNP);
}

// x: (B, H, W, C) NHWC; w: (3, 3, C, Co) HWIO; bias: (Co,) or null;
// out: (B, H, W, Co). Requires C % CK == 0 and Co % 128 == 0; C == CFIX
// when CFIX is not 0.
template <typename T, int CFIX>
__global__ void __launch_bounds__(C3_THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ out,
               int H, int W, int C_rt, int Co) {
  const int C = CFIX ? CFIX : C_rt;
  constexpr int CK = Conv3Cfg<T>::CK, CKP = Conv3Cfg<T>::CKP;
  constexpr int BNP = Conv3Cfg<T>::BNP;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int HR = C3_HR, HC = C3_HC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* halo = reinterpret_cast<T*>(smem_raw);
  T* wts = halo + HR * HC * CKP;

  const int tid = threadIdx.x;
  const int tiles_w = (W + C3_TW - 1) / C3_TW;
  const int r0 = (blockIdx.x / tiles_w) * C3_TH;   // output tile origin
  const int c0 = (blockIdx.x % tiles_w) * C3_TW;
  const int n0 = blockIdx.y * C3_BN;
  const int b = blockIdx.z;
  const T* xb = x + size_t(b) * H * W * C;

  // thread tile = 8 pixels (one half-row) x 8 channels
  const int tn = tid % 16, tm = tid / 16;
  const int prow = tm >> 1, pcol0 = (tm & 1) * 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += CK) {
    // halo tile, reflect-mapped at load time
    constexpr int VPP = CK / VEC;
    for (int i = tid; i < HR * HC * VPP; i += C3_THREADS) {
      const int pix = i / VPP, v = i % VPP;
      const int gr = reflect_idx(r0 - 1 + pix / HC, H);
      const int gc = reflect_idx(c0 - 1 + pix % HC, W);
      const uint4 val = __ldg(reinterpret_cast<const uint4*>(
          xb + (size_t(gr) * W + gc) * C + ci0 + v * VEC));
      *reinterpret_cast<uint4*>(halo + pix * CKP + v * VEC) = val;
    }
    // weights [tap][ci][co] for this chunk and output block
    constexpr int VPR = C3_BN / VEC;
    for (int i = tid; i < 9 * CK * VPR; i += C3_THREADS) {
      const int row = i / VPR, v = i % VPR;
      const int tap = row / CK, ci = row % CK;
      const uint4 val = __ldg(reinterpret_cast<const uint4*>(
          w + (size_t(tap) * C + ci0 + ci) * Co + n0 + v * VEC));
      *reinterpret_cast<uint4*>(wts + row * BNP + v * VEC) = val;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const float* hp = halo + ((prow + ky) * HC + pcol0 + kx) * CKP;
      const float* wp = wts + tap * CK * BNP + tn * 4;
#pragma unroll 4
      for (int ci = 0; ci < CK; ++ci) {
        float a[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = hp[j * CKP + ci];
        const float4 b0 = *reinterpret_cast<const float4*>(wp + ci * BNP);
        const float4 b1 = *reinterpret_cast<const float4*>(wp + ci * BNP + 64);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] += a[j] * b0.x; acc[j][1] += a[j] * b0.y;
          acc[j][2] += a[j] * b0.z; acc[j][3] += a[j] * b0.w;
          acc[j][4] += a[j] * b1.x; acc[j][5] += a[j] * b1.y;
          acc[j][6] += a[j] * b1.z; acc[j][7] += a[j] * b1.w;
        }
      }
    }
    __syncthreads();
  }

  const int r = r0 + prow;
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tn * 4 + (j < 4 ? j : 60 + j);
    bv[j] = bias ? bias[n] : 0.f;
  }
  if (r < H) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + pcol0 + j;
      if (c < W) {
        float* o = out + ((size_t(b) * H + r) * W + c) * Co + n0 + tn * 4;
        *reinterpret_cast<float4*>(o) = make_float4(
            acc[j][0] + bv[0], acc[j][1] + bv[1], acc[j][2] + bv[2], acc[j][3] + bv[3]);
        *reinterpret_cast<float4*>(o + 64) = make_float4(
            acc[j][4] + bv[4], acc[j][5] + bv[5], acc[j][6] + bv[6], acc[j][7] + bv[7]);
      }
    }
  }
}

// ---------------------------------------------------------------- 7x7 thin
constexpr int C7_TW = 64, C7_R = 4, C7_TY = 4, C7_TH = C7_R * C7_TY;
constexpr int C7_K = 7, C7_HR = C7_TH + C7_K - 1, C7_HC = C7_TW + C7_K - 1;
constexpr int C7_CK = 8, C7_THREADS = C7_TW * C7_TY;

template <int CO>
constexpr size_t conv7_smem_bytes() {
  return sizeof(float) * (size_t(C7_CK) * C7_HR * C7_HC + size_t(C7_CK) * 49 * CO);
}

// x: (B, H, W, C) NHWC; w: (7, 7, C, CO) HWIO; bias: (CO,) or null;
// out: (B, H, W, CO). Requires C % 8 == 0.
template <typename T, int CO>
__global__ void __launch_bounds__(C7_THREADS)
conv7_thin_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ out,
                  int H, int W, int C) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* halo = reinterpret_cast<float*>(smem_raw);   // [ci][HR][HC]
  float* wsm = halo + C7_CK * C7_HR * C7_HC;           // [ci][kx][ky][co]

  const int tid = threadIdx.x;
  const int tx = tid % C7_TW, ty = tid / C7_TW;
  const int tiles_w = (W + C7_TW - 1) / C7_TW;
  const int r0 = (blockIdx.x / tiles_w) * C7_TH;
  const int c0 = (blockIdx.x % tiles_w) * C7_TW;
  const int b = blockIdx.y;
  const T* xb = x + size_t(b) * H * W * C;

  float acc[C7_R][CO];
#pragma unroll
  for (int r = 0; r < C7_R; ++r)
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[r][co] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += C7_CK) {
    for (int pix = tid; pix < C7_HR * C7_HC; pix += C7_THREADS) {
      const int hr = pix / C7_HC, hc = pix % C7_HC;
      const int gr = reflect_idx(r0 - 3 + hr, H);
      const int gc = reflect_idx(c0 - 3 + hc, W);
      const T* src = xb + (size_t(gr) * W + gc) * C + ci0;
      __align__(16) T v[C7_CK];
#pragma unroll
      for (int q = 0; q < C7_CK * int(sizeof(T)) / 16; ++q)
        reinterpret_cast<uint4*>(v)[q] = __ldg(reinterpret_cast<const uint4*>(src) + q);
#pragma unroll
      for (int ci = 0; ci < C7_CK; ++ci)
        halo[(ci * C7_HR + hr) * C7_HC + hc] = to_f(v[ci]);
    }
    for (int i = tid; i < C7_CK * 49 * CO; i += C7_THREADS) {
      const int co = i % CO, t = i / CO;
      const int ky = t % 7, kx = (t / 7) % 7, ci = t / 49;
      wsm[i] = to_f(w[(size_t(ky * 7 + kx) * C + ci0 + ci) * CO + co]);
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < C7_CK; ++ci) {
      const float* hp = halo + (ci * C7_HR + ty * C7_R) * C7_HC + tx;
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
        float v[C7_R + 6];
#pragma unroll
        for (int i = 0; i < C7_R + 6; ++i) v[i] = hp[i * C7_HC + kx];
        const float* wp = wsm + (ci * 7 + kx) * 7 * CO;
#pragma unroll
        for (int ky = 0; ky < 7; ++ky)
#pragma unroll
          for (int co = 0; co < CO; ++co) {
            const float wv = wp[ky * CO + co];
#pragma unroll
            for (int r = 0; r < C7_R; ++r) acc[r][co] += v[r + ky] * wv;
          }
      }
    }
    __syncthreads();
  }

  const int c = c0 + tx;
  if (c >= W) return;
#pragma unroll
  for (int r = 0; r < C7_R; ++r) {
    const int row = r0 + ty * C7_R + r;
    if (row >= H) continue;
    T* o = out + ((size_t(b) * H + row) * W + c) * CO;
#pragma unroll
    for (int co = 0; co < CO; ++co)
      o[co] = from_f<T>(acc[r][co] + (bias ? to_f(bias[co]) : 0.f));
  }
}

template <typename T, int CFIX>
int launch_conv3(const void* x, const void* w, const void* bias, void* out,
                 int B, int H, int W, int C, int Co, cudaStream_t stream) {
  if (C % Conv3Cfg<T>::CK || Co % C3_BN || (CFIX && C != CFIX))
    return int(cudaErrorInvalidValue);
  const size_t smem = conv3_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<T, CFIX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles = ((H + C3_TH - 1) / C3_TH) * ((W + C3_TW - 1) / C3_TW);
  dim3 grid(tiles, Co / C3_BN, B);
  conv3x3_kernel<T, CFIX><<<grid, C3_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), H, W, C, Co);
  return int(cudaGetLastError());
}

template <typename T, int CO>
int launch_conv7_co(const void* x, const void* w, const void* bias, void* out,
                    int B, int H, int W, int C, cudaStream_t stream) {
  const size_t smem = conv7_smem_bytes<CO>();
  cudaError_t err = cudaFuncSetAttribute(
      conv7_thin_kernel<T, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles = ((H + C7_TH - 1) / C7_TH) * ((W + C7_TW - 1) / C7_TW);
  dim3 grid(tiles, B);
  conv7_thin_kernel<T, CO><<<grid, C7_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), H, W, C);
  return int(cudaGetLastError());
}

template <typename T>
int launch_conv7(const void* x, const void* w, const void* bias, void* out,
                 int B, int H, int W, int C, int Co, cudaStream_t stream) {
  switch (Co) {
    case 1: return launch_conv7_co<T, 1>(x, w, bias, out, B, H, W, C, stream);
    case 2: return launch_conv7_co<T, 2>(x, w, bias, out, B, H, W, C, stream);
    case 3: return launch_conv7_co<T, 3>(x, w, bias, out, B, H, W, C, stream);
    case 4: return launch_conv7_co<T, 4>(x, w, bias, out, B, H, W, C, stream);
    case 5: return launch_conv7_co<T, 5>(x, w, bias, out, B, H, W, C, stream);
    case 6: return launch_conv7_co<T, 6>(x, w, bias, out, B, H, W, C, stream);
    case 7: return launch_conv7_co<T, 7>(x, w, bias, out, B, H, W, C, stream);
    case 8: return launch_conv7_co<T, 8>(x, w, bias, out, B, H, W, C, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16. Each returns a cudaError_t value
// (0 on success); the launch is asynchronous on `stream`.
// The two 3x3 launchers are float32 only: in bf16 these convs are
// lama_conv3x3_wgmma (conv3x3_wgmma.cu).
extern "C" int lama_reflect_conv3x3_cols(const void* x, const void* w,
                                         const void* bias, void* out, int B,
                                         int H, int W, int C, int Co,
                                         int dtype, void* stream) {
  if (dtype) return int(cudaErrorInvalidValue);
  return launch_conv3<float, 128>(x, w, bias, out, B, H, W, C, Co,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int lama_reflect_conv3x3_taps(const void* x, const void* w,
                                         const void* bias, void* out, int B,
                                         int H, int W, int C, int Co,
                                         int dtype, void* stream) {
  if (dtype) return int(cudaErrorInvalidValue);
  return launch_conv3<float, 0>(x, w, bias, out, B, H, W, C, Co,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int lama_reflect_out_conv7x7(const void* x, const void* w,
                                        const void* bias, void* out, int B,
                                        int H, int W, int C, int Co,
                                        int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_conv7<bf16>(x, w, bias, out, B, H, W, C, Co, s)
               : launch_conv7<float>(x, w, bias, out, B, H, W, C, Co, s);
}
