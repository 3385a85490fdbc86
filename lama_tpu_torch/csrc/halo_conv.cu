// Reflect-'same' convolutions with the halo built on chip, hand-written for
// Hopper (sm_90a). Bound to Python through the extern "C" launchers at the
// bottom (ctypes; see lama_tpu_torch/ops/kernels/halo_conv.py).
//
// Kernel 7 only: the other kernel of lama_tpu/ops/pallas/halo_conv.py,
// halo_conv3x3_reflect (halo_conv.py:53, kernel 6), is csrc/conv3x3_simt.cu
// in fp32 and csrc/conv3x3_wgmma.cu in bf16. Inside stem_conv.py's envelope
// (7x7, stride 1, C <= 8, C_out a multiple of 16 up to 64: the generators'
// stem) kernel 7 runs csrc/stem_conv.cu in both dtypes; this file takes
// its other shapes.
//
// Replaces the TPU kernel lama_tpu/ops/pallas/halo_conv.py::
// halo_conv_reflect_tiled (halo_conv.py:158): conv2d(reflect_pad(x, k // 2),
// w, b, stride) for k in {3, 7} and stride in {1, 2}. The TPU kernel fetches
// a row block plus its neighbours' halo rows, rebuilds torch-reflect rows at
// the image edges and reflect-pads W in VMEM (halo_conv.py:101-138). Here a
// block copies its input rows, halo rows and halo columns into shared memory
// through the reflect index map (torch 'reflect': row -1 reads row 1, row H
// reads row H-2), so no padded tensor reaches HBM either. The TPU kernel's
// C % 8, W % 128 and H % (16 s) conditions are its sublane and lane tiling;
// this kernel takes any C >= 1, C_out >= 1 and H, W > k // 2, and at stride 2
// the output is ceil(H / 2) x ceil(W / 2), as torch's conv gives.
//
// Layout: x NHWC, weights HWIO, out NHWC, all in x's type (float32 or
// bfloat16); fp32 accumulation (fp32 operands as they are, no TF32), bf16
// rounded once at the store. SIMT kernel (halo_conv_kernel): a block owns an
// output tile of 8 rows x 32 columns x 32 output channels and walks the
// input channels in chunks of CK = 4. Each chunk stages the tile's input
// halo ((8 - 1) s + k rows x (32 - 1) s + k columns) as fp32 channel planes,
// and the chunk's k x k x 4 x 32 weights, in shared memory. A thread owns
// one output column, 4 output rows and 8 output channels (32 fp32
// accumulators): per input channel and kx it reads a strip of 3 s + k input
// values once and reuses each for all k ky taps, and reads its 8 channels'
// weights as two float4 broadcasts (the 32 threads of a warp share them).
// CK = 4 fits the generator's 4-channel stem (masked image + mask, 7x7 ->
// 64) with no padded channels.
// Bound: the stem (b, 4, H, W) -> 64 does 2 * 49 * 4 * 64 FLOP per pixel
// against 4 inputs read and 64 outputs written: FMA-bound in fp32 on the
// SIMT units (67 TFLOP/s), bytes-bound in bf16 on the tensor cores (989
// TFLOP/s). So bf16 convs with k * k * C <= 256, the stem among them, take
// a second kernel, an implicit GEMM on the tensor cores (halo_conv_tc_kernel
// below); the SIMT kernel serves fp32 and the other bf16 shapes.
//
// No backward kernel: the TPU kernel has none (nor a custom_vjp; the JAX
// package never differentiates it); the port's autograd wrapper takes the
// VJP of the plain reflect pad + conv, as for the other reflect convs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

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

constexpr int TH = 8, TW = 32, COB = 32, CK = 4, R = 4, COT = 8;
constexpr int THREADS = 256;   // 32 columns x 2 row groups x 4 channel groups

template <int K, int S> struct Tile {
  static constexpr int HR = (TH - 1) * S + K;   // halo rows
  static constexpr int HC = (TW - 1) * S + K;   // halo columns
  static constexpr int V = (R - 1) * S + K;     // input strip per (ci, kx)
  static constexpr size_t smem = sizeof(float) *
      (size_t(CK) * HR * HC + size_t(CK) * K * K * COB);
};

// x: (B, H, W, C); w: (K, K, C, Co); bias: (Co,) or null;
// out: (B, Ho, Wo, Co) with Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1.
template <typename T, int K, int S>
__global__ void __launch_bounds__(THREADS)
halo_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out,
                 int H, int W, int C, int Co) {
  using TL = Tile<K, S>;
  constexpr int P = K / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* halo = reinterpret_cast<float*>(smem_raw);     // [ci][HR][HC]
  float* wsm = halo + CK * TL::HR * TL::HC;             // [ci][ky][kx][COB]

  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int tid = threadIdx.x;
  const int tx = tid % TW, g = tid / TW;
  const int rg = g % 2, cg = g / 2;                      // row / channel group
  const int tiles_w = (Wo + TW - 1) / TW;
  const int r0 = (blockIdx.x / tiles_w) * TH;           // output tile origin
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * COB;
  const int b = blockIdx.z;
  const T* xb = x + size_t(b) * H * W * C;

  float acc[R][COT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < COT; ++j) acc[r][j] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += CK) {
    // halo tile, reflect-mapped at load time; channels fastest, so the
    // threads of a warp read neighbouring addresses of an NHWC pixel run
    for (int i = tid; i < TL::HR * TL::HC * CK; i += THREADS) {
      const int ci = i % CK, pix = i / CK;
      const int hr = pix / TL::HC, hc = pix % TL::HC;
      float v = 0.f;
      if (ci0 + ci < C) {
        const int gr = reflect_idx(S * r0 - P + hr, H);
        const int gc = reflect_idx(S * c0 - P + hc, W);
        v = to_f(xb[(size_t(gr) * W + gc) * C + ci0 + ci]);
      }
      halo[(ci * TL::HR + hr) * TL::HC + hc] = v;
    }
    // weights [ci][ky][kx][co] for this chunk and output block
    for (int i = tid; i < CK * K * K * COB; i += THREADS) {
      const int co = i % COB, t = i / COB;
      const int kx = t % K, ky = (t / K) % K, ci = t / (K * K);
      float v = 0.f;
      if (ci0 + ci < C && n0 + co < Co)
        v = to_f(w[(size_t(ky * K + kx) * C + ci0 + ci) * Co + n0 + co]);
      wsm[i] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < CK; ++ci) {
      const float* hp = halo + (ci * TL::HR + S * rg * R) * TL::HC + S * tx;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        float v[TL::V];
#pragma unroll
        for (int i = 0; i < TL::V; ++i) v[i] = hp[i * TL::HC + kx];
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const float* wp = wsm + ((ci * K + ky) * K + kx) * COB + cg * COT;
          const float4 w0 = *reinterpret_cast<const float4*>(wp);
          const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float a = v[S * r + ky];
            acc[r][0] += a * w0.x; acc[r][1] += a * w0.y;
            acc[r][2] += a * w0.z; acc[r][3] += a * w0.w;
            acc[r][4] += a * w1.x; acc[r][5] += a * w1.y;
            acc[r][6] += a * w1.z; acc[r][7] += a * w1.w;
          }
        }
      }
    }
    __syncthreads();
  }

  const int c = c0 + tx;
  if (c >= Wo) return;
  const int n = n0 + cg * COT;
  float bv[COT];
#pragma unroll
  for (int j = 0; j < COT; ++j)
    bv[j] = (bias && n + j < Co) ? to_f(bias[n + j]) : 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + rg * R + r;
    if (row >= Ho) continue;
    T* o = out + ((size_t(b) * Ho + row) * Wo + c) * Co + n;
#pragma unroll
    for (int j = 0; j < COT; ++j)
      if (n + j < Co) o[j] = from_f<T>(acc[r][j] + bv[j]);
  }
}

// ---------------------------------------------------------- bf16, small K
// For bf16 with k * k * C <= TC_KMAX (the stem: 7 x 7 x 4 = 196) the conv is
// one implicit GEMM per block on the tensor cores: M = an 8 x 16 output
// tile (128 pixels), N = 64 output channels, K = the k * k * C taps and
// channels, zero-padded to a multiple of 16. The block stages the tile's
// reflect-mapped halo (all C channels) and the K x 64 weights in shared
// memory, expands the halo into the 128 x K im2col matrix there (one
// column per thread, through a table of halo offsets), and 8 warps run
// WMMA 16x16x16 (fp32 accumulate), one 16-pixel row each. The accumulators
// are staged back through shared memory, so each pixel's 64 channels leave
// as 128 contiguous bytes. With C = 4 no input channel is padded, and the
// input is read once per tile; the bound is the output's bytes.
constexpr int TC_TH = 8, TC_TW = 16, TC_M = TC_TH * TC_TW, TC_N = 64;
constexpr int TC_KMAX = 256, TC_THREADS = 256;
constexpr int TC_BP = TC_N + 8, TC_SP = TC_N + 4;   // B and stage pitches

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// bytes of the A region, which the fp32 stage reuses; a multiple of 128
__host__ __device__ inline size_t tc_a_bytes(int kp) {
  const size_t a = size_t(TC_M) * (kp + 8) * 2, st = size_t(TC_M) * TC_SP * 4;
  return ((a > st ? a : st) + 127) / 128 * 128;
}

__host__ inline size_t tc_smem_bytes(int K, int S, int C) {
  const int kp = round16(K * K * C);
  const int hr = (TC_TH - 1) * S + K, hc = (TC_TW - 1) * S + K;
  return tc_a_bytes(kp) + size_t(kp) * TC_BP * 2 + size_t(kp) * 4 +
         size_t(hr) * hc * C * 2;
}

template <int K, int S>
__global__ void __launch_bounds__(TC_THREADS)
halo_conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias, bf16* __restrict__ out,
                    int H, int W, int C, int Co) {
  using namespace nvcuda;
  constexpr int P = K / 2;
  constexpr int HR = (TC_TH - 1) * S + K, HC = (TC_TW - 1) * S + K;
  const int KK = K * K * C, KP = round16(KK), AP = KP + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* A = reinterpret_cast<bf16*>(smem_raw);                // [TC_M][AP]
  const size_t a_bytes = tc_a_bytes(KP);
  bf16* Bm = reinterpret_cast<bf16*>(smem_raw + a_bytes);     // [KP][TC_BP]
  int* off = reinterpret_cast<int*>(Bm + size_t(KP) * TC_BP);  // [KP]
  bf16* halo = reinterpret_cast<bf16*>(off + KP);              // [HR][HC][C]

  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int tid = threadIdx.x;
  const int tiles_w = (Wo + TC_TW - 1) / TC_TW;
  const int r0 = (blockIdx.x / tiles_w) * TC_TH;
  const int c0 = (blockIdx.x % tiles_w) * TC_TW;
  const int n0 = blockIdx.y * TC_N;
  const int b = blockIdx.z;
  const bf16* xb = x + size_t(b) * H * W * C;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < HR * HC * C; i += TC_THREADS) {
    const int c = i % C, pix = i / C;
    const int gr = reflect_idx(S * r0 - P + pix / HC, H);
    const int gc = reflect_idx(S * c0 - P + pix % HC, W);
    halo[i] = xb[(size_t(gr) * W + gc) * C + c];
  }
  // column kidx = (ky * K + kx) * C + c of the im2col matrix, which is also
  // the row of the HWIO weights, reads halo[pixel + off[kidx]]
  for (int k = tid; k < KP; k += TC_THREADS) {
    const int c = k % C, t = k / C;
    off[k] = k < KK ? ((t / K) * HC + t % K) * C + c : -1;
  }
  for (int i = tid; i < KP * TC_N; i += TC_THREADS) {
    const int n = i % TC_N, k = i / TC_N;
    Bm[k * TC_BP + n] = (k < KK && n0 + n < Co) ? w[size_t(k) * Co + n0 + n] : zero;
  }
  __syncthreads();
  for (int k = tid; k < KP; k += TC_THREADS) {
    const int o = off[k];
#pragma unroll 4
    for (int m = 0; m < TC_M; ++m) {
      const int base = (S * (m / TC_TW) * HC + S * (m % TC_TW)) * C;
      A[m * AP + k] = o >= 0 ? halo[base + o] : zero;
    }
  }
  __syncthreads();

  const int warp = tid / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TC_N / 16];
#pragma unroll
  for (int j = 0; j < TC_N / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < KP; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, A + warp * 16 * AP + k0, AP);
#pragma unroll
    for (int j = 0; j < TC_N / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, Bm + k0 * TC_BP + j * 16, TC_BP);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
  __syncthreads();   // A is free: stage the fp32 accumulators there
  float* stage = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int j = 0; j < TC_N / 16; ++j)
    wmma::store_matrix_sync(stage + warp * 16 * TC_SP + j * 16, acc[j], TC_SP,
                            wmma::mem_row_major);
  __syncthreads();
  const bool vec = Co % 8 == 0;
  for (int i = tid; i < TC_M * (TC_N / 8); i += TC_THREADS) {
    const int m = i / (TC_N / 8), v = i % (TC_N / 8);
    const int r = r0 + m / TC_TW, c = c0 + m % TC_TW, n = n0 + v * 8;
    if (r >= Ho || c >= Wo || n >= Co) continue;
    bf16* o = out + ((size_t(b) * Ho + r) * Wo + c) * Co + n;
    __align__(16) bf16 pk[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      pk[e] = __float2bfloat16(stage[m * TC_SP + v * 8 + e] +
                               ((bias && n + e < Co) ? __bfloat162float(bias[n + e]) : 0.f));
    if (vec) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(pk);
    } else {
      for (int e = 0; e < 8 && n + e < Co; ++e) o[e] = pk[e];
    }
  }
}

template <int K, int S>
int launch_tc(const void* x, const void* w, const void* bias, void* out, int B,
              int H, int W, int C, int Co, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(K, S, C);
  cudaError_t err = cudaFuncSetAttribute(
      halo_conv_tc_kernel<K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int tiles = ((Ho + TC_TH - 1) / TC_TH) * ((Wo + TC_TW - 1) / TC_TW);
  dim3 grid(tiles, (Co + TC_N - 1) / TC_N, B);
  halo_conv_tc_kernel<K, S><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), H, W, C, Co);
  return int(cudaGetLastError());
}

template <typename T, int K, int S>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
           int H, int W, int C, int Co, cudaStream_t stream) {
  constexpr int P = K / 2;
  if (C < 1 || Co < 1 || H <= P || W <= P) return int(cudaErrorInvalidValue);
  if (std::is_same<T, bf16>::value && K * K * C <= TC_KMAX)
    return launch_tc<K, S>(x, w, bias, out, B, H, W, C, Co, stream);
  const size_t smem = Tile<K, S>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      halo_conv_kernel<T, K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int tiles = ((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW);
  dim3 grid(tiles, (Co + COB - 1) / COB, B);
  halo_conv_kernel<T, K, S><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), H, W, C, Co);
  return int(cudaGetLastError());
}

template <typename T>
int launch_ks(const void* x, const void* w, const void* bias, void* out, int B,
              int H, int W, int C, int Co, int K, int S, cudaStream_t stream) {
  if (K == 3 && S == 1) return launch<T, 3, 1>(x, w, bias, out, B, H, W, C, Co, stream);
  if (K == 3 && S == 2) return launch<T, 3, 2>(x, w, bias, out, B, H, W, C, Co, stream);
  if (K == 7 && S == 1) return launch<T, 7, 1>(x, w, bias, out, B, H, W, C, Co, stream);
  if (K == 7 && S == 2) return launch<T, 7, 2>(x, w, bias, out, B, H, W, C, Co, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16. H, W: the input's; out is
// (B, (H - 1) / S + 1, (W - 1) / S + 1, Co). Returns a cudaError_t value (0
// on success); the launch is asynchronous on `stream`.
extern "C" int lama_halo_conv_reflect_tiled(const void* x, const void* w,
                                            const void* bias, void* out, int B,
                                            int H, int W, int C, int Co, int K,
                                            int S, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_ks<bf16>(x, w, bias, out, B, H, W, C, Co, K, S, s)
               : launch_ks<float>(x, w, bias, out, B, H, W, C, Co, K, S, s);
}
