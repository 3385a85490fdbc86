// The thin 7x7 reflect-padded convolution of the FFC generator's RGB head,
// hand-written for Hopper (sm_90a), in float32 and bfloat16. Bound to Python
// through lama_reflect_out_conv7x7 at the bottom (ctypes; see
// lama_tpu_torch/ops/kernels/reflect_conv.py).
//
// Replaces the TPU kernel lama_tpu/ops/pallas/reflect_conv.py::
// reflect_out_conv7x7 (:327; 7x7, C_out <= 8: the 64 -> 3 head), kernel 5.
// The other reflect convs of that file are csrc/conv3x3_simt.cu in float32
// and csrc/conv3x3_wgmma.cu in bfloat16: cols and taps (3x3 stride 1) and
// the downsamples (3x3 stride 2).
//
// What the TPU kernel keeps out of HBM, this keeps out too: the reflect halo
// is built while the input tile is copied into shared memory (torch
// 'reflect': row -1 reads row 1, row H reads row H-2), so no padded tensor
// is ever written. Layout is channels-last (NHWC): one pixel's input
// channels are contiguous, so a halo pixel's 8-channel chunk is one or two
// 16-byte vector loads.
//
// conv7_thin_kernel: C_out = 3 wastes any GEMM tile, so each thread owns
// one column of R = 4 output pixels and all C_out channels (R * C_out
// accumulators) and walks a register strip of R + 6 input rows per
// (channel, kx), reusing each loaded value for all 7 ky taps. The halo
// tile (16+6) x (64+6) per 8-channel chunk lives in shared memory as fp32
// channel planes, so a warp reads 32 consecutive columns without bank
// conflicts; weights sit in [ci][kx][ky][co] order. Bound: 49 * C * C_out
// FMA per pixel against C inputs read once, FMA-bound on the SIMT units.
//
// No backward kernel: the TPU kernel has none either (its custom_vjp takes
// the VJP of the plain reflect pad + conv), and the port does the same in a
// torch.autograd.Function.

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

// dtype code: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int lama_reflect_out_conv7x7(const void* x, const void* w,
                                        const void* bias, void* out, int B,
                                        int H, int W, int C, int Co,
                                        int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_conv7<bf16>(x, w, bias, out, B, H, W, C, Co, s)
               : launch_conv7<float>(x, w, bias, out, B, H, W, C, Co, s);
}
