// The FFC generator's RGB head for Hopper (sm_90a): reflect pad 3, then a
// 7x7 stride-1 conv of C input channels (8 <= C <= 128, C % 8 == 0) into
// C_out <= 8 output channels, optional bias, NHWC in and out, float32 or
// bfloat16 with fp32 accumulation. Bound to Python through
// lama_reflect_out_conv7x7 at the bottom (ctypes; see
// lama_tpu_torch/ops/kernels/head_conv.py, whose constants, plan, weight
// packing and bf16 fragment maps mirror this file's).
//
// Replaces the TPU kernel lama_tpu/ops/pallas/reflect_conv.py::
// reflect_out_conv7x7 (:327), kernel 5: big-lama's and big-lama-regular's
// 64 -> 3 head. The reflect halo is built on chip (torch 'reflect': row -1
// reads row 1, row H reads row H - 2); no padded tensor reaches HBM. The
// bias is added in fp32 before the output's one rounding; the TPU kernel
// adds it after its bf16 cast (:376-380), a difference well inside the
// bf16 tolerance of 2e-2.
//
// Bound: 2 * 49 * C * C_out FLOP per output pixel against C values read
// and C_out written. At (16, 64, 512, 512) -> 3 that is 79 GFLOP against
// 0.56 GB in bf16 and 1.12 GB in fp32. bf16 is bound by its bytes, nearly
// all of them the input (0.168 ms against 0.080 ms of tensor-core FLOP);
// fp32 on the SIMT FMA units (67 TFLOP/s) by its FLOP (1.178 ms).
//
// One skeleton for both precisions (head_conv_kernel):
//   * A persistent 1-D grid of min(tiles, SMs) blocks of 256 threads, each
//     walking items (tile, channel chunk): tiles t = blockIdx.x,
//     + gridDim.x, ..., and for each tile its chunks of CK input channels.
//   * The packed weights (head_conv.py::pack_weight, chunk-major) staged in
//     shared memory once per block when they fit beside the ring (every
//     main-path shape: C = 64); otherwise (C = 128 at wide C_out) each
//     ring stage carries its chunk's slice. The bias, zero past C_out, once.
//   * A cp.async ring of RING stages: the item RING - 1 ahead loads its
//     reflect-mapped halo chunk while the current one computes.
//   * An epilogue that adds the bias in fp32 and writes 16-byte stores.
//
// fp32 (full FFMA, no TF32, no mma): a 32 x 64 output tile; a thread owns
// a 2-D register tile of 2 x 4 pixels x C_out. A ring stage holds 4
// channels of the 38 x 70 halo pixels, 16 bytes a pixel (one 16-byte
// cp.async a pixel where x is 16-byte aligned, else element loads), the
// pixels of a row XOR-swizzled (f_unit) so that the 8 lanes of a quarter
// warp, 8 consecutive 4-pixel column groups, read 8 distinct bank groups.
// Per ky and output row a thread loads the row's 10 halo pixels its 4
// read across the 7 kx taps (10 LDS.128, 4 channels each), and per ky the
// 7 x C_out weights of the 4 channels as float4 broadcasts, held in
// registers across its 2 rows (C_out <= 3): per stage 140 halo and 7 *
// KXP weight loads per 4 * 8 * 49 * C_out FFMA, in a branch-free loop
// body. Its 4 pixels x C_out
// outputs are contiguous in NHWC: C_out 16-byte stores straight from
// registers where aligned, else element stores.
//
// bf16: mma.sync.aligned.m16n8k16 (bf16 operands, fp32 accumulation) with
// N = (kx, co), 7 * C_out columns padded to NT n-tiles of 8, K = (ky, c),
// and M = 16 consecutive halo columns of one halo row. For output row r,
// D[j][(kx, co)] = sum_{ky, c} halo[r + ky][j][c] * w[ky, kx, c, co], then
// out[r][x][co] = sum_kx D[x + kx][(kx, co)]: a shifted sum over kx, done
// once per row after all of K. A tile is 8 * R output rows x 58 columns:
// warp w owns rows w * R .. w * R + R - 1 (R = 2 where NT <= 3, else 1,
// for the registers) and 4 m-tiles (64 halo columns: the 58 outputs + 6).
// A ring stage holds 16 channels (one k-step) of (8R + 6) x 64 halo
// pixels, 32 bytes a pixel, its two 16-byte halves XOR-swizzled by bit 2
// of the pixel so that an ldmatrix's 8 rows fall on 8 distinct bank
// groups. A comes straight from the NHWC halo rows by ldmatrix.x4, with
// no im2col: each halo row's fragment is loaded once per k-step and serves
// the warp's R output rows (one ky each) x NT n-tiles. B is packed in
// fragment order (head_conv.py::pack_weight), one 8-byte load a lane.
// Channels past C read zeros (the copies zero-fill) against zero weights.
// The epilogue writes each m-tile's D rows into a per-warp ring of 32 D
// rows, and after each m-tile sums the outputs whose 7 D rows are staged
// (x in [0, 10), [10, 26), [26, 42), [42, 58): each once, 7 loads each),
// adds the bias, stages the bf16 row and writes it as 16-byte stores,
// element stores at the ends of the row.
//
// No backward kernel: the TPU kernel has none either (its custom_vjp,
// _diff_wrap7 :383, takes the VJP of the plain reflect pad + conv), and
// the port does the same in a torch.autograd.Function.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

using bf16 = __nv_bfloat16;

namespace {

constexpr int KS = 7, PAD = 3;             // kernel size, reflect pad
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_CO = 8, MAX_C = 128, MIN_SIDE = 8;
constexpr int BIAS_BYTES = MAX_CO * 4;
constexpr int BLOCK_SMEM = 232448;         // shared memory of one block
constexpr int MAX_DEVICES = 64;

// fp32: a thread's F_RH x F_RW pixels; F_TX x F_TY threads; F_CK channels
// (one 16-byte halo pixel) a stage
constexpr int F_RH = 2, F_RW = 4, F_TX = 16, F_TY = 16;
constexpr int F_TILE_H = F_TY * F_RH, F_TILE_W = F_TX * F_RW;    // 32 x 64
constexpr int F_HALO_H = F_TILE_H + KS - 1, F_HALO_W = F_TILE_W + KS - 1;
constexpr int F_CK = 4, F_RING = 3;        // channels a stage: 16 bytes
static_assert(F_TX * F_TY == THREADS && F_RW == 4 && F_TX == 16 && F_CK == 4,
              "a warp: 8 column groups x 4 row groups; a halo pixel is one "
              "16-byte unit of 4 channels");

// the 16-byte unit of halo pixel px within its row: bits 3-4 of px flip
// bits 0-1, which keeps each aligned group of 4 pixels in place
__host__ __device__ constexpr int f_unit(int px) { return px ^ ((px >> 3) & 3); }
// a quarter warp's LDS.128: tx = 0..7 (or 8..15) read pixel 4 tx + j, j
// in [0, 10), on 8 distinct bank groups; the swizzle stays inside a row
constexpr bool fp32_conflict_free() {
  for (int base = 0; base <= 8; base += 8)
    for (int j = 0; j < F_RW + KS - 1; ++j) {
      int seen = 0;
      for (int tx = base; tx < base + 8; ++tx)
        seen |= 1 << (f_unit(4 * tx + j) % 8);
      if (seen != 0xff) return false;
    }
  for (int px = 0; px < F_HALO_W; ++px)
    if (f_unit(px) >= F_HALO_W) return false;
  return true;
}
static_assert(fp32_conflict_free(), "fp32 halo: LDS.128 bank conflict");

// bf16: B_MT m-tiles of 16 halo columns a warp row; B_CK channels a stage
constexpr int B_MT = 4, B_HALO_W = 16 * B_MT;                    // 64
constexpr int B_TILE_W = B_HALO_W - KS + 1;                      // 58
constexpr int B_CK = 16, B_PIX_BYTES = B_CK * 2;                 // 32
constexpr int B_ROW_BYTES = B_HALO_W * B_PIX_BYTES;              // 2048
constexpr int B_RING = 3;
constexpr int B_FRAG_BYTES = 32 * 8;       // one B fragment, lane order
constexpr int D_ROWS = 32;                 // bf16 epilogue: D rows a warp
static_assert(D_ROWS >= 16 + KS - 1 && D_ROWS % 16 == 0,
              "an m-tile's 16 D rows and the 6 before it stay staged");

// the 16-byte unit of (halo pixel px, channel half) within a halo row:
// the halves swap on pixels whose bit 2 is set
__host__ __device__ constexpr int b_unit(int px, int half) {
  return 2 * px + (half ^ ((px >> 2) & 1));
}
// an ldmatrix phase reads one 8x8 matrix: 8 consecutive pixels (from a
// multiple of 8) at one half, which must fall on 8 distinct bank groups
constexpr bool ldmatrix_conflict_free() {
  for (int half = 0; half < 2; ++half) {
    int seen = 0;
    for (int rr = 0; rr < 8; ++rr) seen |= 1 << (b_unit(rr, half) % 8);
    if (seen != 0xff) return false;
  }
  return true;
}
static_assert(ldmatrix_conflict_free(), "bf16 A: ldmatrix bank conflict");
static_assert(B_CK == 16 && B_PIX_BYTES == 32, "one k-step a stage");
static_assert(THREADS % (2 * B_HALO_W) == 0, "bf16 halo copies: whole columns");

// The plan of one instance: T float or bf16, CO output channels.
template <typename T, int CO> struct Plan {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int NT = (KS * CO + 7) / 8;           // bf16 n-tiles
  static constexpr int R = NT <= 3 ? 2 : 1;              // bf16 rows a warp
  static constexpr int TILE_H = BF16 ? WARPS * R : F_TILE_H;
  static constexpr int TILE_W = BF16 ? B_TILE_W : F_TILE_W;
  static constexpr int HALO_H = TILE_H + KS - 1;
  static constexpr int CK = BF16 ? B_CK : F_CK;
  static constexpr int RING = BF16 ? B_RING : F_RING;
  static constexpr int KXP = (KS * CO + 3) / 4 * 4;      // fp32 (c, ky) row
  static constexpr int CHUNK_W = BF16 ? KS * NT * B_FRAG_BYTES
                                      : F_CK * KS * KXP * 4;
  static constexpr int HALO_BYTES = BF16 ? HALO_H * B_ROW_BYTES
                                         : F_HALO_H * F_HALO_W * 16;
  // bf16 epilogue, per warp: a ring of D_ROWS D rows [D_ROWS][DP] fp32 (DP
  // odd: the kx sums' reads spread over the banks), then the bf16 output
  // row at its 16-byte phase
  static constexpr int DP = NT * 8 + 1;
  static constexpr int EPI_WARP_BYTES =
      BF16 ? (D_ROWS * DP * 4 + (7 + B_TILE_W * CO) * 2 + 15) / 16 * 16 : 0;
  using Acc = std::conditional_t<BF16, float[R][B_MT][NT][4],
                                 float[F_RH][F_RW][CO]>;
  static_assert(CO >= 1 && CO <= MAX_CO, "C_out");
  static_assert(CHUNK_W % 16 == 0 && HALO_BYTES % 16 == 0, "16-byte copies");
  static_assert((D_ROWS * DP * 4) % 16 == 0, "16-byte staged output row");
};

// Shared-memory layout of a launch: the weights (staged once) or none,
// the bias, RING stages (halo, and the chunk's weights if not once), the
// bf16 epilogue buffers
struct Layout { int once, bias, stage, stage_bytes, epi, total; };

template <typename T, int CO>
Layout layout(int chunks, bool once) {
  using PL = Plan<T, CO>;
  Layout L;
  L.once = once;
  L.bias = once ? chunks * PL::CHUNK_W : 0;
  L.stage = L.bias + BIAS_BYTES;
  L.stage_bytes = PL::HALO_BYTES + (once ? 0 : PL::CHUNK_W);
  L.epi = L.stage + PL::RING * L.stage_bytes;
  L.total = L.epi + WARPS * PL::EPI_WARP_BYTES;
  return L;
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

// the four 8x8 bf16 matrices whose rows lanes 8i..8i+7 address, into
// a[i] in the mma fragment layout (lane (g, t): row g, columns 2t, 2t + 1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
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

// fp32: one output row's acc[p][co] += channel C (a compile-time index:
// the component of each float4 halo pixel) over the 7 kx taps of one ky;
// w: the (C, ky) weights, element kx * CO + co
template <int CO, int C, int KXP>
__device__ __forceinline__ void fma_taps(float (&acc)[F_RW][CO],
                                         const float4 (&a)[F_RW + KS - 1],
                                         const float (&w)[KXP]) {
#pragma unroll
  for (int kx = 0; kx < KS; ++kx)
#pragma unroll
    for (int co = 0; co < CO; ++co)
#pragma unroll
      for (int p = 0; p < F_RW; ++p) {
        const float4& v = a[p + kx];
        const float av = C == 0 ? v.x : C == 1 ? v.y : C == 2 ? v.z : v.w;
        acc[p][co] += av * w[kx * CO + co];
      }
}

// the (c, ky) weights of the chunk [c][ky][KXP] at wk = wp + ky * KXP
template <int KXP>
__device__ __forceinline__ void load_w(float (&w)[KXP], const float* wk, int c) {
#pragma unroll
  for (int v = 0; v < KXP / 4; ++v) {
    const float4 t = *reinterpret_cast<const float4*>(wk + c * KS * KXP + 4 * v);
    w[4 * v] = t.x; w[4 * v + 1] = t.y; w[4 * v + 2] = t.z; w[4 * v + 3] = t.w;
  }
}

// channel C and on of one output row and ky, and output row R and on:
// recursions, so that every index into the accumulators and the weights
// is a compile-time one
template <int CO, bool HOIST, int KXP, int C>
__device__ __forceinline__ void fma_chans(float (&acc)[F_RW][CO],
                                          const float4 (&a)[F_RW + KS - 1],
                                          const float* wk,
                                          const float (&wh)[F_CK][KXP]) {
  if constexpr (C < F_CK) {
    if constexpr (HOIST) {
      fma_taps<CO, C>(acc, a, wh[C]);
    } else {
      float w[KXP];
      load_w(w, wk, C);
      fma_taps<CO, C>(acc, a, w);
    }
    fma_chans<CO, HOIST, KXP, C + 1>(acc, a, wk, wh);
  }
}

template <int CO, bool HOIST, int KXP, int R = 0>
__device__ __forceinline__ void fma_rows(float (&acc)[F_RH][F_RW][CO],
                                         const float4* hrow,
                                         const int (&u)[F_RW + KS - 1],
                                         const float* wk,
                                         const float (&wh)[F_CK][KXP]) {
  if constexpr (R < F_RH) {
    float4 a[F_RW + KS - 1];   // the row's 10 halo pixels, 4 channels each
#pragma unroll
    for (int j = 0; j < F_RW + KS - 1; ++j) a[j] = hrow[R * F_HALO_W + u[j]];
    fma_chans<CO, HOIST, KXP, 0>(acc[R], a, wk, wh);
    fma_rows<CO, HOIST, KXP, R + 1>(acc, hrow, u, wk, wh);
  }
}

// fp32: acc[r][p][co] += one chunk's F_CK channels over all 49 taps. hp:
// the stage's halo row of the thread's first output row (ky 0), F_HALO_W
// 16-byte pixels; tx its column group; wp: the chunk's weights
// [c][ky][KXP], element kx * CO + co. Per ky, branch-free: the 4
// channels' weights once into registers where they fit (C_out <= 3),
// else per (row, channel); then per output row its halo row (10 LDS.128)
// and 4 * 7 * 4 * CO FFMA.
template <int CO>
__device__ __forceinline__ void fma_chunk(float (&acc)[F_RH][F_RW][CO],
                                          const float4* hp, int tx,
                                          const float* wp) {
  constexpr int KXP = Plan<float, CO>::KXP;
  constexpr bool HOIST = F_CK * KXP <= 96;
  int u[F_RW + KS - 1];
#pragma unroll
  for (int j = 0; j < F_RW + KS - 1; ++j) u[j] = f_unit(F_RW * tx + j);
#pragma unroll 1
  for (int ky = 0; ky < KS; ++ky) {
    float wh[F_CK][KXP];
    if constexpr (HOIST) {
#pragma unroll
      for (int c = 0; c < F_CK; ++c) load_w(wh[c], wp + ky * KXP, c);
    }
    fma_rows<CO, HOIST, KXP>(acc, hp + ky * F_HALO_W, u, wp + ky * KXP, wh);
  }
}

// bf16: acc[r][mt][nt] += one chunk (16 channels) of the warp's R output
// rows. hbase: the stage's halo row of the warp's first output row (ky 0);
// wk: the chunk's B fragments [ky][nt][lane], 8 bytes a lane.
template <int CO>
__device__ __forceinline__ void mma_chunk(typename Plan<bf16, CO>::Acc& acc,
                                          uint32_t hbase,
                                          const unsigned char* wk, int lane) {
  using PL = Plan<bf16, CO>;
  // lane l addresses row l % 8 of matrix l / 8: matrices 0-3 are rows 0-7
  // / 8-15 (pixels) x k 0-7 / 8-15 (channels) as a0..a3 of m16n8k16
  const int q = lane >> 3, rr = lane & 7;
  const uint32_t off = 16 * b_unit(rr + 8 * (q & 1), q >> 1);
#pragma unroll
  for (int h = 0; h < PL::R + KS - 1; ++h) {
    uint32_t a[B_MT][4];
#pragma unroll
    for (int mt = 0; mt < B_MT; ++mt)
      ldmatrix_x4(a[mt], hbase + h * B_ROW_BYTES + mt * 16 * B_PIX_BYTES + off);
#pragma unroll
    for (int r = 0; r < PL::R; ++r) {
      const int ky = h - r;
      if (ky < 0 || ky >= KS) continue;
#pragma unroll
      for (int nt = 0; nt < PL::NT; ++nt) {
        const uint2 bv = reinterpret_cast<const uint2*>(
            wk + (ky * PL::NT + nt) * B_FRAG_BYTES)[lane];
#pragma unroll
        for (int mt = 0; mt < B_MT; ++mt)
          mma_bf16(acc[r][mt][nt], a[mt], bv.x, bv.y);
      }
    }
  }
}

// the accumulators to 0, element by element (no pointer into them, which
// would keep them out of registers)
template <int CO>
__device__ __forceinline__ void zero_acc(float (&acc)[F_RH][F_RW][CO]) {
#pragma unroll
  for (int r = 0; r < F_RH; ++r)
#pragma unroll
    for (int p = 0; p < F_RW; ++p)
#pragma unroll
      for (int co = 0; co < CO; ++co) acc[r][p][co] = 0.f;
}
template <int CO>
__device__ __forceinline__ void zero_acc(typename Plan<bf16, CO>::Acc& acc) {
  using PL = Plan<bf16, CO>;
#pragma unroll
  for (int r = 0; r < PL::R; ++r)
#pragma unroll
    for (int mt = 0; mt < B_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < PL::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][mt][nt][e] = 0.f;
}

// x: (B, H, W, C) NHWC; wpk: head_conv.py::pack_weight's image, 16-byte
// aligned; bias: (CO,) fp32 or null; out: (B, H, W, CO) NHWC, 16-byte
// aligned. vec: x 16-byte aligned, so a pixel's 8- (bf16) or 4-channel
// (fp32) groups are 16-byte copies.
template <typename T, int CO>
__global__ void __launch_bounds__(THREADS, 1)
head_conv_kernel(const T* __restrict__ x, const unsigned char* __restrict__ wpk,
                 const float* __restrict__ bias, T* __restrict__ out, int B,
                 int H, int W, int C, int vec, Layout L) {
  using PL = Plan<T, CO>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int chunks = (C + PL::CK - 1) / PL::CK;
  const int tiles_w = (W + PL::TILE_W - 1) / PL::TILE_W;
  const int tiles_img = ((H + PL::TILE_H - 1) / PL::TILE_H) * tiles_w;
  const int tiles = B * tiles_img;
  const int items = (tiles - int(blockIdx.x) + int(gridDim.x) - 1)
                    / int(gridDim.x) * chunks;
  const T zero{};

  // once per block: the weights (cp.async, with item 0's group) and the
  // bias (zero past CO)
  if (L.once)
    for (int i = tid; i < chunks * PL::CHUNK_W / 16; i += THREADS)
      cp_async16(sbase + 16 * i, wpk + 16 * i, 16);
  float* bsm = reinterpret_cast<float*>(smem + L.bias);
  if (tid < MAX_CO) bsm[tid] = bias && tid < CO ? bias[tid] : 0.f;

  // item q of this block into ring stage q % RING: tile blockIdx.x + (q /
  // chunks) * gridDim.x, chunk q % chunks. Halo pixel (hr, hc) is input
  // pixel (reflect(r0 - 3 + hr), reflect(c0 - 3 + hc)).
  auto load = [&](int q) {
    const int t = int(blockIdx.x) + (q / chunks) * int(gridDim.x), k = q % chunks;
    const int b = t / tiles_img, rem = t % tiles_img;
    const int r0 = (rem / tiles_w) * PL::TILE_H - PAD;
    const int c0 = (rem % tiles_w) * PL::TILE_W - PAD;
    const int soff = L.stage + (q % PL::RING) * L.stage_bytes;
    if (!L.once)
      for (int i = tid; i < PL::CHUNK_W / 16; i += THREADS)
        cp_async16(sbase + soff + PL::HALO_BYTES + 16 * i,
                   wpk + size_t(k) * PL::CHUNK_W + 16 * i, 16);
    const T* xb = x + size_t(b) * H * W * C;
    // a thread copies one halo column (bf16: one channel half of it) at
    // every ROWS-th halo row: its column's reflect and offset once an item
    if constexpr (PL::BF16) {
      constexpr int ROWS = THREADS / (2 * B_HALO_W);
      const int half = tid & 1, px = (tid >> 1) % B_HALO_W;
      const int c = k * B_CK + 8 * half;
      const bool real = c < C;
      const T* col = xb + size_t(reflect_idx(c0 + px, W)) * C + c;
      const int dst = soff + 16 * b_unit(px, half);
      for (int hr = (tid >> 1) / B_HALO_W; hr < PL::HALO_H; hr += ROWS) {
        const T* src = col + size_t(reflect_idx(r0 + hr, H)) * W * C;
        const int off = dst + hr * B_ROW_BYTES;
        if (vec) {
          cp_async16(sbase + off, real ? static_cast<const void*>(src)
                                       : static_cast<const void*>(x), real ? 16 : 0);
        } else {
          T* hs = reinterpret_cast<T*>(smem + off);
#pragma unroll
          for (int e = 0; e < 8; ++e) hs[e] = real ? src[e] : zero;
        }
      }
    } else if (tid < THREADS / F_HALO_W * F_HALO_W) {
      constexpr int ROWS = THREADS / F_HALO_W;
      const int hc = tid % F_HALO_W;
      const T* col = xb + size_t(reflect_idx(c0 + hc, W)) * C + k * F_CK;
      const int dst = soff + 16 * f_unit(hc);
      for (int hr = tid / F_HALO_W; hr < F_HALO_H; hr += ROWS) {
        const T* src = col + size_t(reflect_idx(r0 + hr, H)) * W * C;
        const int off = dst + 16 * hr * F_HALO_W;
        if (vec) {
          cp_async16(sbase + off, src, 16);
        } else {
          T* hs = reinterpret_cast<T*>(smem + off);
#pragma unroll
          for (int e = 0; e < F_CK; ++e) hs[e] = src[e];
        }
      }
    }
  };

  for (int q = 0; q < PL::RING - 1; ++q) {
    if (q < items) load(q);
    cp_async_commit();
  }
  typename PL::Acc acc;
  for (int q = 0; q < items; ++q) {
    cp_async_wait<PL::RING - 2>();
    __syncthreads();   // item q staged by every thread; item q - 1 consumed
    if (q + PL::RING - 1 < items) load(q + PL::RING - 1);
    cp_async_commit();
    const int k = q % chunks;
    if (k == 0) zero_acc<CO>(acc);
    const int soff = L.stage + (q % PL::RING) * L.stage_bytes;
    const unsigned char* wk = L.once ? smem + size_t(k) * PL::CHUNK_W
                                     : smem + soff + PL::HALO_BYTES;
    if constexpr (PL::BF16)
      mma_chunk<CO>(acc, sbase + soff + warp * PL::R * B_ROW_BYTES, wk, lane);
    const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
    if constexpr (!PL::BF16)
      fma_chunk<CO>(acc, reinterpret_cast<const float4*>(smem + soff)
                             + ty * F_RH * F_HALO_W, tx,
                    reinterpret_cast<const float*>(wk));
    if (k != chunks - 1) continue;

    const int t = int(blockIdx.x) + (q / chunks) * int(gridDim.x);
    const int b = t / tiles_img, rem = t % tiles_img;
    const int r0 = (rem / tiles_w) * PL::TILE_H, c0 = (rem % tiles_w) * PL::TILE_W;
    if constexpr (PL::BF16) {
      // per output row: each m-tile's D rows into the warp's ring (D row j
      // at slot j % D_ROWS), then the outputs whose 7 D rows are staged,
      // x in [x0, x1), each summed over kx once, + bias, into the bf16 row
      // staged at its 16-byte phase; then 16-byte stores and element
      // stores at the ends of the row
      float* dsm = reinterpret_cast<float*>(smem + L.epi + warp * PL::EPI_WARP_BYTES);
      T* st = reinterpret_cast<T*>(dsm + D_ROWS * PL::DP);
      const int g = lane >> 2, tq = lane & 3;
      const int valid = min(B_TILE_W, W - c0) * CO;
#pragma unroll
      for (int r = 0; r < PL::R; ++r) {
        const int row = r0 + warp * PL::R + r;
        if (row >= H) break;
        const size_t e0 = ((size_t(b) * H + row) * W + c0) * CO;
        const int ph = int(e0 & 7);
#pragma unroll
        for (int mt = 0; mt < B_MT; ++mt) {
          __syncwarp();
#pragma unroll
          for (int nt = 0; nt < PL::NT; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float* d = dsm + ((16 * mt + g + 8 * hh) % D_ROWS) * PL::DP
                         + nt * 8 + 2 * tq;
              d[0] = acc[r][mt][nt][2 * hh];
              d[1] = acc[r][mt][nt][2 * hh + 1];
            }
          __syncwarp();
          const int x0 = mt == 0 ? 0 : 16 * mt - KS + 1;
          const int x1 = mt == B_MT - 1 ? B_TILE_W : 16 * mt + 16 - KS + 1;
          for (int p = x0 * CO + lane; p < x1 * CO; p += 32) {
            const int x = p / CO, co = p % CO;
            float sum = 0.f;
#pragma unroll
            for (int kx = 0; kx < KS; ++kx)
              sum += dsm[((x + kx) % D_ROWS) * PL::DP + kx * CO + co];
            if (p < valid) st[ph + p] = __float2bfloat16(sum + bsm[co]);
          }
        }
        __syncwarp();
        const int lo = (ph + 7) & ~7, hi = (ph + valid) & ~7;
        T* ob = out + (e0 - ph);
        for (int s = lo + 8 * lane; s + 8 <= hi; s += 8 * 32)
          *reinterpret_cast<uint4*>(ob + s) = *reinterpret_cast<const uint4*>(st + s);
        for (int s = ph + lane; s < ph + valid; s += 32)
          if (s < lo || s >= hi) ob[s] = st[s];
      }
    } else {
      // the thread's 2 x 4 pixels x CO, + bias: a pixel row's 4 * CO
      // floats are contiguous, CO 16-byte stores where aligned
      float bv[CO];
#pragma unroll
      for (int co = 0; co < CO; ++co) bv[co] = bsm[co];
      const int col = c0 + tx * F_RW;
#pragma unroll
      for (int r = 0; r < F_RH; ++r) {
        const int row = r0 + ty * F_RH + r;
        if (row >= H || col >= W) break;
        float* o = reinterpret_cast<float*>(out) + ((size_t(b) * H + row) * W + col) * CO;
        if (col + F_RW <= W && reinterpret_cast<uintptr_t>(o) % 16 == 0) {
          float v[F_RW * CO];
#pragma unroll
          for (int p = 0; p < F_RW; ++p)
#pragma unroll
            for (int co = 0; co < CO; ++co) v[p * CO + co] = acc[r][p][co] + bv[co];
#pragma unroll
          for (int u = 0; u < CO; ++u)
            reinterpret_cast<float4*>(o)[u] =
                make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
        } else {
#pragma unroll
          for (int p = 0; p < F_RW; ++p)
            if (col + p < W)
#pragma unroll
              for (int co = 0; co < CO; ++co) o[p * CO + co] = acc[r][p][co] + bv[co];
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

template <typename T, int CO>
int launch(const void* x, const void* wpk, const void* bias, void* out, int B,
           int H, int W, int C, cudaStream_t stream) {
  using PL = Plan<T, CO>;
  const long long tiles = (long long)B * ((H + PL::TILE_H - 1) / PL::TILE_H)
                          * ((W + PL::TILE_W - 1) / PL::TILE_W);
  const int sms = sm_count();
  const int chunks = (C + PL::CK - 1) / PL::CK;
  if (tiles * chunks > 0x7fffffffLL || sms < 1) return int(cudaErrorInvalidValue);
  Layout L = layout<T, CO>(chunks, true);
  if (L.total > BLOCK_SMEM) L = layout<T, CO>(chunks, false);
  if (L.total > BLOCK_SMEM) return int(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      head_conv_kernel<T, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.total);
  if (err != cudaSuccess) return int(err);
  const unsigned grid = unsigned(tiles < sms ? tiles : sms);
  head_conv_kernel<T, CO><<<grid, THREADS, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(wpk),
      static_cast<const float*>(bias), static_cast<T*>(out), B, H, W, C, vec, L);
  return int(cudaGetLastError());
}

template <typename T>
int launch_co(const void* x, const void* wpk, const void* bias, void* out,
              int B, int H, int W, int C, int Co, cudaStream_t s) {
  switch (Co) {
    case 1: return launch<T, 1>(x, wpk, bias, out, B, H, W, C, s);
    case 2: return launch<T, 2>(x, wpk, bias, out, B, H, W, C, s);
    case 3: return launch<T, 3>(x, wpk, bias, out, B, H, W, C, s);
    case 4: return launch<T, 4>(x, wpk, bias, out, B, H, W, C, s);
    case 5: return launch<T, 5>(x, wpk, bias, out, B, H, W, C, s);
    case 6: return launch<T, 6>(x, wpk, bias, out, B, H, W, C, s);
    case 7: return launch<T, 7>(x, wpk, bias, out, B, H, W, C, s);
    case 8: return launch<T, 8>(x, wpk, bias, out, B, H, W, C, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16. x: (B, H, W, C) NHWC in that type,
// 8 <= C <= 128, C % 8 == 0; wpk: head_conv.py::pack_weight's image for
// that type and Co, 16-byte aligned; bias: (Co,) fp32 or null; out: (B, H,
// W, Co) NHWC in x's type, 16-byte aligned, 1 <= Co <= 8; H, W >= 8.
// Returns a cudaError_t value (0 on success); the launch is asynchronous
// on `stream`.
extern "C" int lama_reflect_out_conv7x7(const void* x, const void* wpk,
                                        const void* bias, void* out, int B,
                                        int H, int W, int C, int Co,
                                        int dtype, void* stream) {
  if (B < 1 || C < 8 || C > MAX_C || C % 8 || Co < 1 || Co > MAX_CO ||
      H < MIN_SIDE || W < MIN_SIDE || reinterpret_cast<uintptr_t>(wpk) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_co<bf16>(x, wpk, bias, out, B, H, W, C, Co, s)
               : launch_co<float>(x, wpk, bias, out, B, H, W, C, Co, s);
}
