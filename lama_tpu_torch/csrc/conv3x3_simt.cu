// fp32 3x3 reflect-padded convolution of any channel counts, stride 1
// ('same') or stride 2, as one register-tiled SIMT implicit GEMM for Hopper
// (sm_90a). Bound to Python through lama_conv3x3_simt (stride 1) and
// lama_conv3x3_s2_simt (stride 2) at the bottom (ctypes; see
// lama_tpu_torch/ops/kernels/conv3x3_simt.py, whose constants, plan, split
// rule and weight packing mirror this file's).
//
// Replaces the fp32 paths of four TPU kernels:
//   lama_tpu/ops/pallas/reflect_conv.py::reflect_conv3x3_cols (:130),
//     kernel 2 (3x3 stride 1, C = C_out = 128; the FFC's l2l convs), at
//     stride 1;
//   lama_tpu/ops/pallas/reflect_conv.py::reflect_conv3x3_taps (:465),
//     kernel 3 (3x3 stride 1, C and C_out multiples of 128; l2g and g2l),
//     at stride 1;
//   lama_tpu/ops/pallas/halo_conv.py::halo_conv3x3_reflect (:53), kernel 6
//     (3x3 stride 1, any C and C_out; the GlobalGenerator's 512 -> 512
//     ResnetBlock convs), at stride 1;
//   lama_tpu/ops/pallas/reflect_conv.py::reflect_down_conv3x3 (:230),
//     kernel 4 (3x3 stride 2, 2C and C_out multiples of 128, H and W even;
//     the four downsample convs), at stride 2.
// Their bf16 paths are csrc/conv3x3_wgmma.cu. The reflect halo is built on
// chip (torch 'reflect': row -1 reads row 1, row H reads row H-2); no
// padded tensor reaches HBM. Layout: x and out NHWC, weights packed by the
// wrapper (below).
//
// Arithmetic: full fp32 FMA on the SIMT units. No TF32 and no split-TF32
// on the tensor cores: the port's fp32 is its reference numerics, and
// chip_smoke.py's refiner gradient check resolves kernel-vs-plain
// differences near 1e-6 relative.
//
// Bound: 2 * 9 * C * C_out FLOP per output pixel against (S^2 C + C_out) * 4
// bytes: ~1150 FLOP/B at 512 -> 512, ~290 at 128 -> 128 and ~96 FLOP/B at
// the smallest downsample (64 -> 128 at stride 2), every shape far above
// the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/B). So the
// FMA units bound it, and the design keeps them fed:
//   * Tiles. A block owns 8 x 16 output pixels (TILE_H x TILE_W, M = 128)
//     and 128 output channels (BLOCK_N), and walks K = 9 taps x C input
//     channels in chunks of CK. Each staged halo value feeds 128 output
//     channels and 9 taps; each staged weight 128 pixels.
//   * Register tile. 256 threads, each 8 pixels (one 8-pixel run of an
//     output row, S halo pixels apart) x 8 output channels (tn * 4 + 0..3
//     and 64 + tn * 4 + 0..3): 64 fp32 accumulators. Per 4 input channels
//     (a step) a thread reads its 8 pixels' 4 channels as 8 LDS.128 and 4
//     channels' 8 outputs as 8 LDS.128 broadcasts, then does 256 FFMA: 16
//     LDS.128 per 256 FFMA. The next step's 16 loads go out before this
//     step's FFMAs (two register buffers), and the nine taps of a chunk are
//     unrolled: 3-8% faster than one step at a time and a rolled tap loop
//     at the b16 shapes (conv3x3_variants; PERF.md).
//   * No bank conflict. Lane l of warp w has channel group tn = 8 (w % 2)
//     + l % 8 and pixel group 4 (w / 2) + l / 8, so a quarter-warp (the 8
//     lanes one LDS.128 wavefront serves) reads one A address (a
//     broadcast) and 8 consecutive 16-byte B vectors (128 B). A warp's four
//     A addresses are four consecutive output rows, S * HALO_W * CKP floats
//     apart; the halo pixel pitch CKP = CK + 4 puts them on four distinct
//     16-byte bank groups (a static_assert below), and the four
//     quarter-warps read the same B vectors. So each LDS.128 is one
//     wavefront: 16 wavefronts per 256 FFMA a warp, a quarter of shared
//     memory's rate at the FMA units' pace.
//   * Weights packed once per call by the wrapper: [n tile][chunk][tap][CK
//     input channels][128 output channels], zero-filled past C and C_out,
//     so a stage's 9 x CK x 128 weights are one contiguous run of 16-byte
//     copies.
//   * Asynchronous staging: a ring of STAGES stages, filled by cp.async
//     16-byte copies from reflect-mapped addresses (the row and column
//     maps computed once per tile, not per chunk); channel tails are
//     zero-filled by the copy's source size (4-byte copies where C % 4 !=
//     0), which covers kernel 6's any C. Chunk k + STAGES - 1's halo and
//     weights load while chunk k's FFMAs run.
//   * Shared memory (227 KB a block), CK = 8 at both strides: a stride-1
//     stage is a 10 x 18-pixel halo at pitch 12 (8.4 KB) and 36 KB of
//     weights, four stages; at stride 2 the halo is 17 x 33 pixels (26.3
//     KB), three stages. One block of 8 warps per SM; each thread's 64
//     independent accumulators hide the FFMA latency. The constants were
//     picked with python -m lama_tpu_torch.tools.conv3x3_variants simt
//     (PERF.md): at stride 1 four 8-channel stages beat two 16-channel
//     ones by 3%; two stages at stride 2 and a 16 x 8 tile lose 1-2%.
//   * Any shape: partial edge tiles masked at the store (halo rows and
//     columns of outputs that are never stored are clamped), 16-byte
//     stores of 4 channels where C_out % 4 == 0.
//   * A split over K where a stride-1 grid fills less than one wave. One
//     block a SM, so a grid of n < 132 blocks leaves SMs idle while each
//     block walks all of K (batch 1 at the refiner's 63 x 48 bottleneck:
//     24 blocks). With `splits` = s > 1 the grid is s times larger: block
//     (tile, n tile, b * s + i) walks chunks [i * chunks / s, (i + 1) *
//     chunks / s) and stores its 8 x 16 x 128 partial sums, without bias,
//     to a workspace (s, B, Ho, Wo, C_out padded to 128) that the wrapper
//     allocates; split_reduce_kernel then adds the s partials in the order
//     0 .. s - 1, then the bias, and writes out. A fixed order and no
//     atomics: the same inputs give the same bits on every run. The
//     wrapper's plan (conv3x3_simt.py::split_count) picks s: only where n
//     < SMs, at most MAX_SPLITS, and at least STAGES chunks a split. With s
//     = 1 the kernel is the unsplit instance (SPLIT false), with no
//     workspace and no second launch.
//
// No backward kernel: the TPU kernels have none; the port's autograd
// wrapper takes the plain version's VJP.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 8, TILE_W = 16;   // output pixels per block (M = 128)
constexpr int BLOCK_N = 128;             // output channels per block
constexpr int THREADS = 256;             // 16 pixel groups x 16 channel groups
constexpr int CHUNK_C = 8;               // input channels per stage (s1)
constexpr int STAGES = 4;                // pipeline stages (s1)
constexpr int S2_CHUNK_C = 8;            // input channels per stage (s2)
constexpr int S2_STAGES = 3;             // pipeline stages (s2)
constexpr int PITCH_PAD = 4;             // halo pixel pitch = CK + PITCH_PAD
constexpr int TAP_UNROLL = 9;            // taps unrolled in the inner loop
constexpr int SMEM_LIMIT = 232448;       // shared memory of one block
constexpr int MAX_SPLITS = 4;            // K splits of a stride-1 grid (s1)
constexpr int REDUCE_THREADS = 256;      // split_reduce_kernel's block
static_assert(TILE_W % 8 == 0 && TILE_H * TILE_W == 16 * 8,
              "16 pixel groups of 8 pixels in a row");
static_assert(BLOCK_N == 128, "16 channel groups of 2 x 4 channels");

// the warp's four pixel-group rows, `units` 16-byte units apart, fall on
// four distinct 16-byte bank groups (8 per 128-byte bank row)
constexpr bool distinct_bank_groups(int units) {
  return (units % 8) % 2 == 1 || units % 8 == 2 || units % 8 == 6;
}

// the tile plan at stride S (1 or 2)
template <int S> struct Plan {
  static constexpr int CK = S == 1 ? CHUNK_C : S2_CHUNK_C;
  static constexpr int RING = S == 1 ? STAGES : S2_STAGES;
  static constexpr int CKP = CK + PITCH_PAD;                 // floats a pixel
  static constexpr int HALO_H = S * (TILE_H - 1) + 3;
  static constexpr int HALO_W = S * (TILE_W - 1) + 3;
  static constexpr int HALO_PIX = HALO_H * HALO_W;
  static constexpr int HALO_FLOATS = HALO_PIX * CKP;
  static constexpr int WEIGHT_FLOATS = 9 * CK * BLOCK_N;
  static constexpr int STAGE_FLOATS = HALO_FLOATS + WEIGHT_FLOATS;
  static constexpr int SMEM_BYTES = RING * STAGE_FLOATS * 4;
  // 16-byte vectors a halo pixel, and 4-channel FFMA steps a tap
  static constexpr int VPP = CK / 4;
  static constexpr int HALO_ITEMS = HALO_PIX * VPP;          // copies a stage
  static constexpr int HALO_PER_THREAD = (HALO_ITEMS + THREADS - 1) / THREADS;
  static constexpr int WEIGHT_PER_THREAD = WEIGHT_FLOATS / 4 / THREADS;
  static_assert(S == 1 || S == 2, "stride");
  static_assert(CK % 4 == 0 && THREADS % VPP == 0, "chunk");
  static_assert(VPP % 2 == 0, "two fragment buffers: an even step count");
  static_assert(PITCH_PAD % 4 == 0, "16-byte aligned halo pixels");
  static_assert(WEIGHT_FLOATS % (4 * THREADS) == 0, "weight copies per thread");
  static_assert(RING >= 2 && SMEM_BYTES <= SMEM_LIMIT, "shared memory of one block");
  static_assert(distinct_bank_groups(S * HALO_W * CKP / 4), "bank conflict");
};

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
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed copy groups are pending
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// one 4-channel step's operands: a thread's 8 pixels' 4 channels (A, 8
// LDS.128) and those 4 channels' weights for its 8 outputs (B, 8 LDS.128)
struct Frag {
  float4 a[8], b0[4], b1[4];
};

template <int S, int CKP>
__device__ __forceinline__ void load_frag(Frag& f, const float* hp,
                                          const float* wp) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    f.a[j] = *reinterpret_cast<const float4*>(hp + j * S * CKP);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f.b0[q] = *reinterpret_cast<const float4*>(wp + q * BLOCK_N);
    f.b1[q] = *reinterpret_cast<const float4*>(wp + q * BLOCK_N + 64);
  }
}

// acc[pixel][output] += A * B: 256 FFMA
__device__ __forceinline__ void fma_frag(float (&acc)[8][8], const Frag& f) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float av = q == 0 ? f.a[j].x : q == 1 ? f.a[j].y
                     : q == 2 ? f.a[j].z : f.a[j].w;
      acc[j][0] += av * f.b0[q].x; acc[j][1] += av * f.b0[q].y;
      acc[j][2] += av * f.b0[q].z; acc[j][3] += av * f.b0[q].w;
      acc[j][4] += av * f.b1[q].x; acc[j][5] += av * f.b1[q].y;
      acc[j][6] += av * f.b1[q].z; acc[j][7] += av * f.b1[q].w;
    }
  }
}

// floats from a thread's halo pixel at tap (0, 0) to the one at `tap`
template <typename P>
__device__ __forceinline__ int tap_offset(int tap) {
  return ((tap / 3) * P::HALO_W + tap % 3) * P::CKP;
}

// x: (B, H, W, C) NHWC fp32; wpk: the packed weights (see the header);
// bias: (Co,) fp32 or null; out: (B, Ho, Wo, Co) NHWC fp32 with Ho =
// (H - 1) / S + 1, Wo = (W - 1) / S + 1 (torch's conv of the reflect pad).
// vec_x: C % 4 == 0 and x 16-byte aligned; vec_out: the same for Co and out.
// SPLIT: blockIdx.z is b * splits + the split, whose run of chunks this
// block walks; it stores its partial sums to ws (splits, B, Ho, Wo,
// gridDim.y * BLOCK_N), 16-byte aligned, and neither bias nor out is read.
template <int S, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_simt_kernel(const float* __restrict__ x, const float* __restrict__ wpk,
                    const float* __restrict__ bias, float* __restrict__ out,
                    float* __restrict__ ws, int H, int W, int C, int Co,
                    int splits, int vec_x, int vec_out) {
  using P = Plan<S>;
  extern __shared__ __align__(16) float smem[];
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int tid = threadIdx.x;
  const int tiles_w = (Wo + TILE_W - 1) / TILE_W;
  const int r0 = (blockIdx.x / tiles_w) * TILE_H;   // output tile origin
  const int c0 = (blockIdx.x % tiles_w) * TILE_W;
  const int nt = blockIdx.y, n0 = nt * BLOCK_N;
  const int split = SPLIT ? blockIdx.z % splits : 0;
  const int b = SPLIT ? blockIdx.z / splits : blockIdx.z;
  const int chunks = (C + P::CK - 1) / P::CK;
  // this block's run of chunks, [k0, k0 + nk): all of them unless SPLIT
  const int k0 = SPLIT ? split * chunks / splits : 0;
  const int nk = SPLIT ? (split + 1) * chunks / splits - k0 : chunks;
  const float* xb = x + size_t(b) * H * W * C;
  const float* wn = wpk + size_t(nt) * chunks * P::WEIGHT_FLOATS;

  // this thread's halo copies: item i = tid + q * THREADS is 16-byte vector
  // v = i % VPP (the same for every q) of halo pixel i / VPP, whose
  // reflect-mapped source pixel is the same for every chunk
  const int v = tid % P::VPP;
  int src_pix[P::HALO_PER_THREAD];
#pragma unroll
  for (int q = 0; q < P::HALO_PER_THREAD; ++q) {
    const int p = (tid + q * THREADS) / P::VPP;
    const int gr = reflect_idx(S * r0 - 1 + p / P::HALO_W, H);
    const int gc = reflect_idx(S * c0 - 1 + p % P::HALO_W, W);
    src_pix[q] = gr * W + gc;
  }

  auto load_stage = [&](int stage, int chunk) {
    const uint32_t st = smem_base + stage * P::STAGE_FLOATS * 4;
    const int c = chunk * P::CK + v * 4;
#pragma unroll
    for (int q = 0; q < P::HALO_PER_THREAD; ++q) {
      const int i = tid + q * THREADS;
      if (i >= P::HALO_ITEMS) break;
      const uint32_t dst = st + ((i / P::VPP) * P::CKP + v * 4) * 4;
      const float* src = xb + size_t(src_pix[q]) * C + c;
      if (vec_x) {
        cp_async16(dst, c < C ? src : xb, c < C ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + 4 * e, c + e < C ? src + e : xb, c + e < C ? 4 : 0);
      }
    }
    const float* wsrc = wn + size_t(chunk) * P::WEIGHT_FLOATS;
    const uint32_t wdst = st + P::HALO_FLOATS * 4;
#pragma unroll
    for (int q = 0; q < P::WEIGHT_PER_THREAD; ++q) {
      const int i = tid + q * THREADS;
      cp_async16(wdst + i * 16, wsrc + 4 * i, 16);
    }
  };

  // lane l of warp w: channel group tn, pixel group pg (see the header)
  const int lane = tid % 32, warp = tid / 32;
  const int tn = (warp % 2) * 8 + lane % 8;
  const int pg = (warp / 2) * 4 + lane / 8;
  const int prow = pg % TILE_H, pcol0 = (pg / TILE_H) * 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < P::RING - 1; ++s) {
    if (s < nk) load_stage(s, k0 + s);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<P::RING - 2>();
    __syncthreads();   // chunk k staged by every thread; chunk k - 1 consumed
    // chunk k + RING - 1 loads (into chunk k - 1's stage) while the FFMAs
    // run chunk k (k counts from this block's first chunk, k0)
    if (k + P::RING - 1 < nk)
      load_stage((k + P::RING - 1) % P::RING, k0 + k + P::RING - 1);
    cp_async_commit();
    const float* halo = smem + (k % P::RING) * P::STAGE_FLOATS;
    const float* wts = halo + P::HALO_FLOATS + tn * 4;
    constexpr int STEPS = P::VPP;
    // a thread's first pixel at tap (0, 0); tap (ky, kx) is ky halo rows
    // and kx pixels on
    const float* hbase = halo + (S * prow * P::HALO_W + S * pcol0) * P::CKP;
    // step s + 1's operands load while step s's FFMAs run; a tap's last
    // step loads the next tap's first (the last tap reloads its own)
    Frag f[2];
    load_frag<S, P::CKP>(f[0], hbase, wts);
#pragma unroll TAP_UNROLL
    for (int tap = 0; tap < 9; ++tap) {
      const int nxt = tap < 8 ? tap + 1 : tap;
      const float* hp = hbase + tap_offset<P>(tap);
      const float* wp = wts + tap * P::CK * BLOCK_N;
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (s + 1 < STEPS)
          load_frag<S, P::CKP>(f[(s + 1) % 2], hp + 4 * (s + 1),
                               wp + 4 * (s + 1) * BLOCK_N);
        else
          load_frag<S, P::CKP>(f[(s + 1) % 2], hbase + tap_offset<P>(nxt),
                               wts + nxt * P::CK * BLOCK_N);
        fma_frag(acc, f[s % 2]);
      }
    }
  }

  const int r = r0 + prow;
  if (r >= Ho) return;
  if constexpr (SPLIT) {
    // the partial sums, all 128 channels of the padded workspace
    const int cop = gridDim.y * BLOCK_N;
    const size_t plane = size_t(gridDim.z / splits) * Ho * Wo;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int c = c0 + pcol0 + p;
      if (c >= Wo) break;
      float* o = ws + ((split * plane + (size_t(b) * Ho + r) * Wo + c) * cop
                       + n0 + tn * 4);
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      *reinterpret_cast<float4*>(o + 64) =
          make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
    }
    return;
  }
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tn * 4 + (j < 4 ? j : 60 + j);
    bv[j] = (bias && n < Co) ? bias[n] : 0.f;
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int c = c0 + pcol0 + p;
    if (c >= Wo) break;
    float* o = out + ((size_t(b) * Ho + r) * Wo + c) * Co;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + tn * 4 + 64 * h, j = 4 * h;
      if (vec_out && n < Co) {
        *reinterpret_cast<float4*>(o + n) = make_float4(
            acc[p][j] + bv[j], acc[p][j + 1] + bv[j + 1],
            acc[p][j + 2] + bv[j + 2], acc[p][j + 3] + bv[j + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < Co) o[n + e] = acc[p][j + e] + bv[j + e];
      }
    }
  }
}

// out[p][n] = (ws[0][p][n] + ws[1][p][n] + ... + ws[splits - 1][p][n]) +
// bias[n], summed in that order; p over the B * Ho * Wo output pixels, ws
// (splits, pixels, cop) with cop = C_out padded to 128 (16-byte aligned).
// One thread per 4 output channels of one pixel; vec_out: C_out % 4 == 0
// and out 16-byte aligned.
__global__ void __launch_bounds__(REDUCE_THREADS)
split_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                    float* __restrict__ out, long long pixels, int Co, int cop,
                    int splits, int vec_out) {
  const int groups = (Co + 3) / 4;
  const long long i = blockIdx.x * (long long)REDUCE_THREADS + threadIdx.x;
  if (i >= pixels * groups) return;
  const long long p = i / groups;
  const int n = int(i % groups) * 4;
  const float* src = ws + p * cop + n;
  float4 s = *reinterpret_cast<const float4*>(src);
  for (int k = 1; k < splits; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(src + k * pixels * cop);
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (bias && n + e < Co) v[e] += bias[n + e];
  float* o = out + p * Co + n;
  if (vec_out) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < Co) o[e] = v[e];
  }
}

template <int S, bool SPLIT>
int launch_conv(const void* x, const void* wpk, const void* bias, void* out,
                void* ws, int B, int H, int W, int C, int Co, int splits,
                cudaStream_t stream) {
  const int vec_x = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_out = Co % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_simt_kernel<S, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan<S>::SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int tiles = ((Ho + TILE_H - 1) / TILE_H) * ((Wo + TILE_W - 1) / TILE_W);
  const int n_tiles = (Co + BLOCK_N - 1) / BLOCK_N;
  dim3 grid(tiles, n_tiles, B * splits);
  conv3x3_simt_kernel<S, SPLIT><<<grid, THREADS, Plan<S>::SMEM_BYTES, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wpk),
      static_cast<const float*>(bias), static_cast<float*>(out),
      static_cast<float*>(ws), H, W, C, Co, splits, vec_x, vec_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return int(err);
  const long long pixels = (long long)B * Ho * Wo;
  const long long threads = pixels * ((Co + 3) / 4);
  split_reduce_kernel<<<unsigned((threads + REDUCE_THREADS - 1) / REDUCE_THREADS),
                        REDUCE_THREADS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<float*>(out), pixels, Co, n_tiles * BLOCK_N, splits, vec_out);
  return int(cudaGetLastError());
}

template <int S>
int launch(const void* x, const void* wpk, const void* bias, void* out,
           void* ws, int B, int H, int W, int C, int Co, int splits,
           void* stream) {
  const int chunks = (C + Plan<S>::CK - 1) / Plan<S>::CK;
  if (B < 1 || C < 1 || Co < 1 || H < 2 || W < 2 ||
      reinterpret_cast<uintptr_t>(wpk) % 16 || splits < 1 ||
      splits > MAX_SPLITS || splits > chunks ||
      (splits > 1 && (S != 1 || !ws || reinterpret_cast<uintptr_t>(ws) % 16)))
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if constexpr (S == 1) {
    if (splits > 1)
      return launch_conv<S, true>(x, wpk, bias, out, ws, B, H, W, C, Co,
                                  splits, st);
  }
  return launch_conv<S, false>(x, wpk, bias, out, nullptr, B, H, W, C, Co, 1,
                               st);
}

}  // namespace

// x: (B, H, W, C) fp32 NHWC; wpk: ceil(Co / 128) * ceil(C / CK) * 9 * CK *
// 128 fp32 (lama_tpu_torch/ops/kernels/conv3x3_simt.py::
// pack_conv3x3_weight), 16-byte aligned; bias: (Co,) fp32 or null; out:
// (B, H, W, Co) fp32 NHWC; splits: 1 .. MAX_SPLITS, at most ceil(C / CK);
// ws: null for splits = 1, else splits * B * H * W * ceil(Co / 128) * 128
// fp32, 16-byte aligned (the partial sums; see the header). Any C, Co >= 1
// and H, W >= 2. Returns a cudaError_t value (0 on success); the launches
// (two where splits > 1) are asynchronous on `stream`.
extern "C" int lama_conv3x3_simt(const void* x, const void* wpk,
                                 const void* bias, void* out, void* ws, int B,
                                 int H, int W, int C, int Co, int splits,
                                 void* stream) {
  return launch<1>(x, wpk, bias, out, ws, B, H, W, C, Co, splits, stream);
}

// The same at stride 2, unsplit (splits 1, ws null): H, W are the input's;
// out is (B, (H - 1) / 2 + 1, (W - 1) / 2 + 1, Co) fp32 NHWC (H / 2 x W / 2
// for the even sides kernel 4 takes).
extern "C" int lama_conv3x3_s2_simt(const void* x, const void* wpk,
                                    const void* bias, void* out, void* ws,
                                    int B, int H, int W, int C, int Co,
                                    int splits, void* stream) {
  return launch<2>(x, wpk, bias, out, ws, B, H, W, C, Co, splits, stream);
}
