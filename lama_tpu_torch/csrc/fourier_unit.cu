// Eval-mode FourierUnit for Hopper (sm_90a): the counterpart of the TPU
// kernel lama_tpu/ops/pallas/fourier_unit.py::fused_fourier_unit, bound to
// Python through the extern "C" launcher at the bottom (ctypes; see
// lama_tpu_torch/ops/kernels/fourier_unit.py).
//
// The unit is five contractions with elementwise work between them:
//   real DFT along W -> complex DFT along H -> 1x1 conv over the planar
//   [re | im] channels with BN folded in, + bias, ReLU -> inverse DFT along
//   H -> inverse real DFT along W.
// The TPU keeps one image's intermediates in VMEM (one program per image).
// At the big-lama shape (B, 64, 64, 192) one image's spectrum is 64 x 66 x
// 192 x 4 B = 3.2 MB, far above the 227 KB of shared memory a block may
// use, so that fusion does not carry over. Here each stage is one launch of
// the strided GEMM below and the spectrum crosses HBM between stages (five
// launches per unit). Every stage is out[b][m][n] = sum_k A[b][m][k] *
// B[b][k][n] where the operands are addressed through "split" strides: an
// index i maps to (i / d) * hi + (i % d) * lo. That one rule expresses all
// five layouts (see _stage_plan in the Python wrapper, which the CPU tests
// replay in numpy), so the index arithmetic lives in one place:
//   DFT stages: A = a twiddle table (<= 2H x 2H, cached in L1/L2), B = the
//               data panel; the spectrum is laid out (B, H, [re|im], Wf, C).
//   conv stage: A = the spectrum read as rows of planar [re | im] channels,
//               B = the folded planar weight, epilogue = + bias, ReLU.
// No cuFFT and no cuBLAS: the DFTs are matmuls with twiddle tables, as in
// the JAX package's DFT-matmul path (lama_tpu/ops/spectral.py).
//
// Arithmetic is fp32 FMA throughout (bf16 input is widened on load), and
// the output is fp32, as the TPU kernel's is. The kernel is a 64 x 64 x 16
// tiled SGEMM, each thread a 4 x 4 register tile, operands staged in shared
// memory. Bound: at (16,64,64,192) the five stages are ~20 GFLOP against
// ~0.5 GB of HBM traffic, but measured on the H100 they are bound by the
// scalar split-indexed operand loads and the 4 x 4 micro-tile's
// shared-memory reads, not by the FMAs: a TF32 tensor-core variant ran
// exactly as fast, prefetching the next k-tile into registers gained
// about 5%, and 128 x 128 tiles with 8 x 8 register tiles lost about 6%.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

// i -> (i / d) * hi + (i % d) * lo
struct SplitIdx {
  int d;
  long long hi, lo;
};

struct GemmView {          // read operand
  const void* p;
  int bf16;                // element type: 0 = float32, 1 = bfloat16
  long long batch_stride;
  SplitIdx row, col;
};

struct GemmOut {           // fp32 result, optional bias over n and ReLU
  float* p;
  long long batch_stride;
  SplitIdx row, col;
  const float* bias;
  int relu;
};

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__device__ __forceinline__ long long split(const SplitIdx& s, int i) {
  return (long long)(i / s.d) * s.hi + (long long)(i % s.d) * s.lo;
}

template <typename T>
__device__ __forceinline__ float to_f(T e) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(e);
  else return e;
}

// Each thread loads a fixed column of the A tile and a fixed column of the
// B tile, so the row offsets of A and the column offset of B are computed
// once, and each k-tile costs one split for A and four for B.
template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
strided_gemm_kernel(int M, int N, int K, GemmView A, GemmView B, GemmOut C) {
  __shared__ __align__(16) float As[BK][BM + 4];   // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN + 4];   // Bs[k][n]
  const int batch = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const TA* pa = static_cast<const TA*>(A.p) + batch * A.batch_stride;
  const TB* pb = static_cast<const TB*>(B.p) + batch * B.batch_stride;

  constexpr int AR = BM * BK / THREADS, BR = BK * BN / THREADS;   // 4, 4
  const int ka = tid % BK, ma = tid / BK;            // A: column ka, rows ma + 16j
  const int nb = tid % BN, kb = tid / BN;            // B: column nb, rows kb + 4j
  long long a_row[AR];
#pragma unroll
  for (int j = 0; j < AR; ++j) {
    const int m = m0 + ma + j * (THREADS / BK);
    a_row[j] = m < M ? split(A.row, m) : -1;
  }
  const long long b_col = n0 + nb < N ? split(B.col, n0 + nb) : -1;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    const long long a_col = k0 + ka < K ? split(A.col, k0 + ka) : -1;
#pragma unroll
    for (int j = 0; j < AR; ++j)
      As[ka][ma + j * (THREADS / BK)] =
          (a_row[j] >= 0 && a_col >= 0) ? to_f(pa[a_row[j] + a_col]) : 0.f;
#pragma unroll
    for (int j = 0; j < BR; ++j) {
      const int k = kb + j * (THREADS / BN);
      Bs[k][nb] = (b_col >= 0 && k0 + k < K)
                      ? to_f(pb[split(B.row, k0 + k) + b_col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
    const long long rbase = batch * C.batch_stride + split(C.row, gm);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (C.bias) v += C.bias[gn];
      if (C.relu) v = fmaxf(v, 0.f);
      C.p[rbase + split(C.col, gn)] = v;
    }
  }
}

}  // namespace

// One stage of the FourierUnit: out[b][m][n] = epilogue(sum_k A[b][m][k] *
// B[b][k][n]) for b < batches. A must be float32; B float32 or bfloat16.
// Returns a cudaError_t value (0 on success); asynchronous on `stream`.
extern "C" int lama_fu_gemm(int M, int N, int K, int batches,
                            const GemmView* A, const GemmView* B,
                            const GemmOut* C, void* stream) {
  if (A->bf16) return int(cudaErrorInvalidValue);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batches);
  auto s = static_cast<cudaStream_t>(stream);
  if (B->bf16)
    strided_gemm_kernel<float, bf16><<<grid, THREADS, 0, s>>>(M, N, K, *A, *B, *C);
  else
    strided_gemm_kernel<float, float><<<grid, THREADS, 0, s>>>(M, N, K, *A, *B, *C);
  return int(cudaGetLastError());
}
