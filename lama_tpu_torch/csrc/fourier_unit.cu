// Eval-mode FourierUnit for Hopper (sm_90a): the counterpart of the TPU
// kernel lama_tpu/ops/pallas/fourier_unit.py::fused_fourier_unit (:130),
// bound to Python through the extern "C" launcher at the bottom (ctypes; see
// lama_tpu_torch/ops/kernels/fourier_unit.py, whose constants, tile rule and
// stage plan mirror this file's).
//
// The unit is five contractions with elementwise work between them:
//   real DFT along W -> complex DFT along H -> 1x1 conv over the planar
//   [re | im] channels with BN folded in, + bias, ReLU -> inverse DFT along
//   H -> inverse real DFT along W.
// The TPU keeps one image's intermediates in VMEM (one program per image).
// At the big-lama shape (B, 64, 64, 192) one image's spectrum is 64 x 66 x
// 192 x 4 B = 3.2 MB, far above the 227 KB of shared memory a block may
// use, so that fusion does not carry over. Here each stage is one launch of
// the GEMM below and the spectrum crosses HBM between stages (five launches
// per unit, ~0.44 GB at batch 16 in bf16: 0.13 ms at 3.35 TB/s, under half
// of the FMA bound). Every stage is out[m][n] = sum_k A[m][k] * B[k][n]
// with A row-major in k and B row-major in n, each index addressed through
// a "split": i maps to (i / d) * hi + (i % d) * lo. That one rule expresses
// all five layouts (see _stage_plan in the Python wrapper, which the CPU
// tests replay in numpy), with the batch merged into N:
//   DFT stages: A = a twiddle table (row pitch padded to 4 floats), B = the
//               data panel; the spectrum is laid out (B, H, [re|im], Wf, C)
//               with its frequencies in the order 1, 2, .., Wf - 1, 0, so
//               the rows that are zero for any real input (Im at f = 0, and
//               at f = W/2 for even W) are the last 2 Wf - W rows of each
//               (b, h) panel: the W-DFT computes the first W rows (M = W)
//               and writes the rest as zeros (zero_rows), and the W-iDFT
//               reads only those W rows (K = W; the dropped rows' weights
//               are sin(0) and sin(pi n)).
//   conv stage: A = the spectrum read as rows of planar [re | im] channels,
//               B = the folded planar weight, epilogue = + bias, ReLU.
// No cuFFT and no cuBLAS: the DFTs are matmuls with twiddle tables, as in
// the JAX package's DFT-matmul path (lama_tpu/ops/spectral.py).
//
// Arithmetic: full fp32 FMA (no TF32, no bf16 operand rounding); bf16 input
// is widened as it is read from shared memory; the output is fp32, as the
// TPU kernel's is.
// store_bf16 (lama_tpu's spectral_bf16_store, lama_tpu/ops/spectral.py:
// 67-96): the four DFT stages round their fp32 sums to bf16 and store them
// so, which halves the bytes between those launches; the conv stage then
// reads a bf16 A (the spectrum) and writes fp32, and the unit's output is
// bf16. The sums stay fp32. Bound: at (16, 192, 64, 64) the five stages are 19.93
// GFLOP (the Pallas cost estimate): 0.297 ms at 67 TFLOP/s, above the bytes'
// 0.13 ms. So the FMA units bound it, and the design is conv3x3_simt.cu's:
//   * Register tile. 256 threads, each 8 rows (g, g + RG, .., g + 7 RG of
//     the block tile, RG = BM / 8 row groups) x 8 columns (4 t .. 4 t + 3
//     and BN / 2 + 4 t .. + 3): 64 fp32 accumulators. Per 4 k (a step) a
//     thread reads its 8 rows' 4 k as 8 LDS.128 (A is staged [m][k], pitch
//     BK + A_PAD) and the 4 k's 8 columns as 8 LDS.128 (B is staged
//     [k][n]), then does 256 FFMA. The next step's loads go out before this
//     step's FFMAs (two register buffers).
//   * No bank conflict. A warp is WR row groups x WC column groups (4 x 8;
//     2 x 16 at BM = 16); a quarter-warp is one row group's 8 consecutive
//     column groups, so an A read is a broadcast and a B read 8 consecutive
//     16-byte vectors, and the warp's WR A rows, (BK + A_PAD) / 4 16-byte
//     units apart, fall on distinct bank groups (a static_assert below).
//   * Asynchronous staging: a ring of 3 stages of BK = 16 k, filled by
//     cp.async 16-byte copies, one barrier a stage (4, 6 and 8 stages and
//     32-deep ones measured slower; PERF.md). The split index is evaluated
//     once per 16-byte run, and a tile's row offsets of A and column offset
//     of B once per tile (the load stream advances its position and offsets
//     as it crosses a tile). A run may not cross a split segment: the plan
//     marks an operand `vec` where every run starts 16-byte aligned inside
//     one segment (C a multiple of 4 fp32 or 8 bf16, table pitches padded);
//     other operands take 4-byte copies (bf16: element loads), with the
//     tails past M, N and K zero-filled by the copy's source size.
//   * A persistent grid: one block a SM (64 accumulators and two operand
//     buffers a thread leave room for one), block b taking tiles b, b +
//     SMs, ..; its (tile, stage) items are one stream through the ring, so
//     the next tile's stages load while this tile's last ones compute and
//     its outputs are stored. The DFT stages' K (48 to 256) is 3 to 16
//     stages, so a tile alone would spend much of its time filling its ring.
//   * Tiles per stage: the kernel is templated on BM (16, 32, 64 or 128;
//     BN = 16384 / BM), and the plan picks for each stage the BM with the
//     least padded M x N (ties to the larger BM), so the W stages' M = W
//     (64, 128, 95, 48 at the served and refine shapes) and the H stages'
//     2H pad by at most 6%. The blocks at work at one time walk the shorter
//     tile axis, so they share the larger operand in L2.
//   * A split over K where the tiles leave SMs idle: with one block a SM a
//     stage takes about ceil(tiles / SMs) tile times, so 36-39 tiles (batch
//     1 at 63 x 48) use under a third of the card, and 141-144 (125 x 95)
//     or 192-198 (128^2, batch 4) leave most of a second round idle. The
//     plan (fourier_unit.py::split_count) then cuts each tile's K into
//     `splits` runs, each a work unit of the stream; a unit stores its
//     partial sums to a workspace and split_reduce_kernel adds the splits
//     in order, then the epilogue. A fixed order and no atomics: the same
//     inputs give the same bits on every run.
//   * Epilogue: + bias and ReLU (the conv stage), 16-byte stores where the
//     output's run is contiguous, masked at the edges; the zero rows.
//
// Measured (python -m lama_tpu_torch.tools.fourier_unit_time, NVIDIA H100
// 80GB HBM3 at 700 W): 0.78 ms a unit at (16, 192, 64, 64) in either
// precision, 38% of the bound (the design before this one: 1.31 ms, 23%).
// The conv stage runs at about 47% of the FMA peak, the H stages at about
// 34%, the W stages at about 23%; neither the ring depth, the stage depth,
// two blocks a SM nor L1-cached tables moved that (PERF.md).
//
// No backward kernel: the TPU kernel has none (the JAX package runs it only
// outside training); the port's autograd wrapper takes the plain VJP.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

// i -> (i / d) * hi + (i % d) * lo; d = NO_SPLIT: i * lo
struct SplitIdx {
  int d;
  long long hi, lo;
};

struct GemmView {          // read operand: A[m][k] (row m, column k) or B[k][n]
  const void* p;
  int bf16;                // element type: 0 = float32, 1 = bfloat16
  int vec;                 // 16-byte runs along the column index (see header)
  SplitIdx row, col;
};

struct GemmOut {           // result, optional bias over n and ReLU
  void* p;
  int vec;                 // 4-element vector stores along n
  SplitIdx row, col;
  const float* bias;
  int relu;
  int zero_rows;           // rows M .. M + zero_rows - 1 stored as zeros
  int bf16;                // element type: 0 = float32, 1 = bfloat16
};

namespace {

constexpr int THREADS = 256;           // 8 x 8 outputs each: BM * BN = 16384
constexpr int BK = 16;                 // k per pipeline stage
constexpr int A_PAD = 4;               // A stage row pitch = BK + A_PAD floats
constexpr int STAGES = 3;              // pipeline ring depth
constexpr int SMEM_LIMIT = 232448;     // shared memory of one block
constexpr int MAX_ZERO_ROWS = 2;       // Im at f = 0 and f = W / 2
constexpr int NO_SPLIT = 1 << 30;
constexpr int MAX_DEVICES = 64;        // SM counts cached by the launcher
constexpr int MAX_SPLITS = 4;          // K splits of a stage (see the header)
constexpr int REDUCE_THREADS = 256;    // split_reduce_kernel's block
constexpr int A_BF16_BM = 128;         // the one tile height of a bf16 A

// `rows` rows, `units` 16-byte units apart, fall on distinct 16-byte bank
// groups (8 per 128-byte bank row)
constexpr bool distinct_bank_groups(int units, int rows) {
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < i; ++j)
      if ((i * units) % 8 == (j * units) % 8) return false;
  return true;
}

// the block tile of one instance: BM rows, A elements of type TA, B
// elements of type TB
template <int BM, typename TA, typename TB> struct Tile {
  static constexpr int RG = BM / 8;               // row groups
  static constexpr int CG = THREADS / RG;         // column groups
  static constexpr int BN = 8 * CG;
  static constexpr int WR = RG < 4 ? RG : 4;      // row groups of a warp
  static constexpr int WC = 32 / WR;              // column groups of a warp
  static constexpr int ELEM = int(sizeof(TB));
  static constexpr int PITCH = BK + A_PAD;
  static constexpr int A_ELEM = int(sizeof(TA));
  // an A row: PITCH floats, or whole 16-byte runs of bf16 (BK + 2 A_PAD)
  static constexpr int A_PITCH = A_ELEM == 4 ? PITCH : BK + 2 * A_PAD;
  static constexpr int A_EV = 16 / A_ELEM;        // A elements a 16-byte copy
  static constexpr int EV = 16 / ELEM;            // B elements a 16-byte copy
  static constexpr int A_BYTES = BM * A_PITCH * A_ELEM;
  static constexpr int STAGE_BYTES = A_BYTES + BK * BN * ELEM;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static constexpr int A_VECS = BM * BK / A_EV;   // 16-byte copies of A a stage
  static constexpr int A_PER_THREAD = (A_VECS + THREADS - 1) / THREADS;
  static constexpr int B_ROW_VECS = BN / EV;      // 16-byte copies a B row
  static constexpr int B_ROWS_PER_PASS = THREADS / B_ROW_VECS;
  static constexpr int B_PER_THREAD = BK / B_ROWS_PER_PASS;
  static constexpr int STEPS = BK / 4;            // FFMA steps a stage
  static_assert(BM % 8 == 0 && THREADS % RG == 0 && BN % 8 == 0, "tile");
  static_assert(RG >= MAX_ZERO_ROWS, "one row group per zero row");
  static_assert(WC % 8 == 0 && CG % WC == 0 && RG % WR == 0,
                "a quarter-warp: one row group, 8 consecutive column groups");
  static_assert(BK % 8 == 0 && THREADS % (BK / 4) == 0, "A copies");
  static_assert(THREADS % B_ROW_VECS == 0 && BK % B_ROWS_PER_PASS == 0,
                "B copies: a thread's column run fixed for a tile");
  static_assert(A_PAD % 4 == 0 && A_BYTES % 16 == 0, "16-byte aligned stages");
  static_assert(A_PITCH * A_ELEM % 16 == 0 && THREADS % (BK / A_EV) == 0,
                "A rows of whole 16-byte runs");
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory of one block");
  static_assert(distinct_bank_groups(PITCH / 4, WR), "bank conflict");
  // a bf16 A row is 3 16-byte units: a warp's rows on distinct bank groups
  static_assert(A_ELEM == 4 || distinct_bank_groups(A_PITCH * A_ELEM / 16, WR),
                "bank conflict");
};

__device__ __forceinline__ long long split(const SplitIdx& s, int i) {
  if (s.d >= NO_SPLIT) return (long long)i * s.lo;
  const unsigned q = unsigned(i) / unsigned(s.d);
  return (long long)q * s.hi + (long long)(unsigned(i) - q * unsigned(s.d)) * s.lo;
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

// 4 consecutive B elements from shared memory, widened to fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// one step's operands: a thread's 8 rows' 4 k (A) and those 4 k's 8
// columns (B)
struct Frag {
  float4 a[8], b0[4], b1[4];
};

template <typename T, typename TA, typename TB>
__device__ __forceinline__ void load_frag(Frag& f, const TA* as, const TB* bs) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    f.a[j] = ld4(as + j * T::RG * T::A_PITCH);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f.b0[q] = ld4(bs + q * T::BN);
    f.b1[q] = ld4(bs + q * T::BN + T::BN / 2);
  }
}

// acc[row][column] += A * B: 256 FFMA
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

// the bits of f rounded to bf16 (nearest even)
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const bf16 b = __float2bfloat16(f);
  return *reinterpret_cast<const unsigned short*>(&b);
}

// 4 outputs of row offset `ro` at columns n .. n + 3 (those below N), as
// fp32 or rounded to bf16 (OUT_BF16); `co` = split(C.col, n), computed once
// per tile
template <bool OUT_BF16>
__device__ __forceinline__ void store4(const GemmOut& C, long long ro,
                                       long long co, int n, int N,
                                       const float (&v)[4]) {
  if (n >= N) return;
  if constexpr (OUT_BF16) {
    unsigned short* p = static_cast<unsigned short*>(C.p);
    if (C.vec && n + 4 <= N) {
      uint2 u;
      u.x = bf16_bits(v[0]) | bf16_bits(v[1]) << 16;
      u.y = bf16_bits(v[2]) | bf16_bits(v[3]) << 16;
      *reinterpret_cast<uint2*>(p + ro + co) = u;
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N) p[ro + split(C.col, n + e)] = (unsigned short)bf16_bits(v[e]);
    return;
  }
  float* p = static_cast<float*>(C.p);
  if (C.vec && n + 4 <= N) {
    *reinterpret_cast<float4*>(p + ro + co) =
        make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (n + e < N) p[ro + split(C.col, n + e)] = v[e];
}

// the tile's epilogue (+ bias, ReLU, the store as fp32 or bf16) and the
// clear of its sums. The kernel picks the store type once a tile, outside
// these loops: a test of C.bf16 at each store slowed the fp32 stages by 3%
// (tools/fourier_unit_time), and a template parameter on the kernel
// doubled its instances and its build time.
template <typename T, bool OUT_BF16>
__device__ __forceinline__ void store_tile(const GemmOut& C, float (&acc)[8][8],
                                           int M, int N, int m0, int n0,
                                           int tg, int tn) {
  constexpr int BN = T::BN;
  // the tile's sums: + bias, ReLU, store, and clear
  long long co[2];
  float bv[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + h * (BN / 2) + tn * 4;
    co[h] = n < N ? split(C.col, n) : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bv[4 * h + e] = (C.bias && n + e < N) ? C.bias[n + e] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int m = m0 + tg + j * T::RG;
    if (m < M) {
      const long long ro = split(C.row, m);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = acc[j][4 * h + e] + bv[4 * h + e];
          if (C.relu) v[e] = fmaxf(v[e], 0.f);
        }
        store4<OUT_BF16>(C, ro, co[h], n0 + h * (BN / 2) + tn * 4, N, v);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  }
  // the rows known to be zero, written by the first row of tiles
  if (m0 == 0 && tg < C.zero_rows) {
    const long long ro = split(C.row, M + tg);
    const float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store4<OUT_BF16>(C, ro, co[h], n0 + h * (BN / 2) + tn * 4, N, z);
  }
}

// out[m][n] = epilogue(sum_k A[m][k] B[k][n]) over BM x BN tiles, each
// tile's K in `splits` runs of stages: work unit u is run u % splits of
// tile u / splits, and block b takes units b, b + gridDim.x, ..; its (unit,
// k stage) items form one stream through the ring, so the next unit's first
// stages load while this unit's last ones compute and its outputs are
// stored. SPLIT (splits > 1): a unit stores its partial sums, without the
// epilogue, to ws (splits, M, N rounded up to 4), and split_reduce_kernel
// finishes the stage; the unsplit instance has one unit a tile.
template <int BM, typename TA, typename TB, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
fu_gemm_kernel(int M, int N, int K, int splits_arg, GemmView A, GemmView B,
               GemmOut C, float* __restrict__ ws) {
  using T = Tile<BM, TA, TB>;
  constexpr int BN = T::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int chunks = (K + BK - 1) / BK;
  const int splits = SPLIT ? splits_arg : 1;
  const int units = tiles_m * tiles_n * splits;
  const int my_units = (units - int(blockIdx.x) + int(gridDim.x) - 1)
                       / int(gridDim.x);
  const TA* pa = static_cast<const TA*>(A.p);
  const TB* pb = static_cast<const TB*>(B.p);

  // the block's j-th unit: its tile origin, run of stages [c0, c1) and
  // split; the shorter tile axis varies fastest, so the blocks at work at
  // one time share the larger operand
  auto unit_of = [&](int j, int& m0, int& n0, int& c0, int& c1, int& sp) {
    const int u = int(blockIdx.x) + j * int(gridDim.x);
    const int t = SPLIT ? u / splits : u;
    sp = SPLIT ? u - t * splits : 0;
    c0 = SPLIT ? sp * chunks / splits : 0;
    c1 = SPLIT ? (sp + 1) * chunks / splits : chunks;
    const bool m_fast = tiles_m <= tiles_n;
    const int fast = m_fast ? t % tiles_m : t % tiles_n;
    const int slow = m_fast ? t / tiles_m : t / tiles_n;
    m0 = (m_fast ? fast : slow) * BM;
    n0 = (m_fast ? slow : fast) * BN;
  };

  // the load stream's position (unit lj, stage lc of its run up to lc1)
  // and that unit's addresses: A copy q of this thread is row (tid + q
  // THREADS) / (BK / A_EV), k run akv; B copies are column run bcv, rows
  // bkr + q B_ROWS_PER_PASS
  const int akv = tid % (BK / T::A_EV);
  const int bcv = tid % T::B_ROW_VECS, bkr = tid / T::B_ROW_VECS;
  int lj = 0, lc = 0, lc1 = 0, bn = 0;
  long long a_row[T::A_PER_THREAD], b_col = -1;
  auto load_unit = [&](int j) {
    int m0, n0, sp;
    unit_of(j, m0, n0, lc, lc1, sp);
#pragma unroll
    for (int q = 0; q < T::A_PER_THREAD; ++q) {
      const int v = tid + q * THREADS, m = m0 + v / (BK / T::A_EV);
      a_row[q] = (v < T::A_VECS && m < M) ? split(A.row, m) : -1;
    }
    bn = n0 + bcv * T::EV;
    b_col = bn < N ? split(B.col, bn) : -1;
  };
  if (my_units > 0) load_unit(0);

  // the stream's next item into `stage`; then advance
  auto load_next = [&](int stage) {
    const uint32_t sa = smem_base + stage * T::STAGE_BYTES;
    const uint32_t sb = sa + T::A_BYTES;
    const int k0 = lc * BK, ka = k0 + akv * T::A_EV;
    const long long a_col = A.vec && ka < K ? split(A.col, ka) : 0;
#pragma unroll
    for (int q = 0; q < T::A_PER_THREAD; ++q) {
      const int v = tid + q * THREADS;
      if (v >= T::A_VECS) break;
      const uint32_t dst = sa + ((v / (BK / T::A_EV)) * T::A_PITCH
                                 + akv * T::A_EV) * T::A_ELEM;
      if (A.vec) {
        const bool ok = a_row[q] >= 0 && ka < K;
        cp_async16(dst, ok ? pa + a_row[q] + a_col : pa,
                   ok ? T::A_ELEM * min(T::A_EV, K - ka) : 0);
      } else if constexpr (T::A_ELEM == 2) {
        // bf16 off the 16-byte rule: element loads
        TA* d = reinterpret_cast<TA*>(smem + (dst - smem_base));
#pragma unroll
        for (int e = 0; e < T::A_EV; ++e)
          d[e] = (a_row[q] >= 0 && ka + e < K) ? pa[a_row[q] + split(A.col, ka + e)]
                                               : __float2bfloat16(0.f);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = a_row[q] >= 0 && ka + e < K;
          cp_async4(dst + 4 * e, ok ? pa + a_row[q] + split(A.col, ka + e) : pa,
                    ok ? 4 : 0);
        }
      }
    }
#pragma unroll 4
    for (int q = 0; q < T::B_PER_THREAD; ++q) {
      const int kr = bkr + q * T::B_ROWS_PER_PASS, k = k0 + kr;
      const uint32_t dst = sb + (kr * BN + bcv * T::EV) * T::ELEM;
      if (B.vec) {
        const bool ok = b_col >= 0 && k < K;
        cp_async16(dst, ok ? pb + split(B.row, k) + b_col : pb,
                   ok ? T::ELEM * min(T::EV, N - bn) : 0);
      } else if constexpr (T::ELEM == 4) {
        const long long ro = k < K ? split(B.row, k) : 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k < K && bn + e < N;
          cp_async4(dst + 4 * e, ok ? pb + ro + split(B.col, bn + e) : pb,
                    ok ? 4 : 0);
        }
      } else {
        // bf16 off the 16-byte rule: element loads (a cp.async copies at
        // least 4 bytes, which may straddle a segment)
        TB* d = reinterpret_cast<TB*>(smem + (dst - smem_base));
        const long long ro = k < K ? split(B.row, k) : 0;
#pragma unroll
        for (int e = 0; e < T::EV; ++e)
          d[e] = (k < K && bn + e < N) ? pb[ro + split(B.col, bn + e)]
                                       : __float2bfloat16(0.f);
      }
    }
    if (++lc == lc1 && ++lj < my_units) load_unit(lj);
  };

  // lane l of warp w: column group tn, row group tg (see the header)
  const int lane = tid % 32, warp = tid / 32;
  constexpr int WARPS_N = T::CG / T::WC;
  const int tn = (warp % WARPS_N) * T::WC + lane % T::WC;
  const int tg = (warp / WARPS_N) * T::WR + lane / T::WC;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (lj < my_units) load_next(s);
    cp_async_commit();
  }
  int i = 0;   // the compute stream's item
  for (int cj = 0; cj < my_units; ++cj) {
    int m0, n0, c0, c1, sp;
    unit_of(cj, m0, n0, c0, c1, sp);
    for (int c = c0; c < c1; ++c, ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // item i staged by every thread; item i - 1 consumed
      // item i + STAGES - 1 loads (into item i - 1's stage) while item i's
      // FFMAs run
      if (lj < my_units) load_next((i + STAGES - 1) % STAGES);
      cp_async_commit();
      const unsigned char* stage = smem + (i % STAGES) * T::STAGE_BYTES;
      const TA* as = reinterpret_cast<const TA*>(stage) + tg * T::A_PITCH;
      const TB* bs = reinterpret_cast<const TB*>(stage + T::A_BYTES) + tn * 4;
      // step s + 1's operands load while step s's FFMAs run
      Frag f[2];
      load_frag<T>(f[0], as, bs);
#pragma unroll
      for (int s = 0; s < T::STEPS; ++s) {
        if (s + 1 < T::STEPS)
          load_frag<T>(f[(s + 1) % 2], as + 4 * (s + 1), bs + 4 * (s + 1) * BN);
        fma_frag(acc, f[s % 2]);
      }
    }

    if constexpr (SPLIT) {
      // the unit's partial sums, rows below M, all of its 4-column runs
      const int np = (N + 3) / 4 * 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = m0 + tg + j * T::RG;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + h * (BN / 2) + tn * 4;
          if (m < M && n < N)
            *reinterpret_cast<float4*>(ws + (size_t(sp) * M + m) * np + n) =
                make_float4(acc[j][4 * h], acc[j][4 * h + 1], acc[j][4 * h + 2],
                            acc[j][4 * h + 3]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
      }
      continue;
    }

    if (C.bf16) store_tile<T, true>(C, acc, M, N, m0, n0, tg, tn);
    else store_tile<T, false>(C, acc, M, N, m0, n0, tg, tn);
  }
}

// A split stage's outputs: out[m][n] = epilogue(ws[0][m][n] + ws[1][m][n] +
// .. + ws[splits - 1][m][n]), summed in that order (the same bits on every
// run), then the zero rows. One thread per 4 columns of a row.
template <bool OUT_BF16>
__global__ void __launch_bounds__(REDUCE_THREADS)
split_reduce_kernel(int M, int N, int splits, const float* __restrict__ ws,
                    GemmOut C) {
  const int groups = (N + 3) / 4, np = groups * 4;
  const long long i = blockIdx.x * (long long)REDUCE_THREADS + threadIdx.x;
  if (i >= (long long)(M + C.zero_rows) * groups) return;
  const int m = int(i / groups), n = int(i % groups) * 4;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (m < M) {
    const float* src = ws + size_t(m) * np + n;
    float4 s = *reinterpret_cast<const float4*>(src);
    for (int k = 1; k < splits; ++k) {
      const float4 t = *reinterpret_cast<const float4*>(src + size_t(k) * M * np);
      s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
    }
    v[0] = s.x; v[1] = s.y; v[2] = s.z; v[3] = s.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (C.bias && n + e < N) v[e] += C.bias[n + e];
      if (C.relu) v[e] = fmaxf(v[e], 0.f);
    }
  }
  store4<OUT_BF16>(C, split(C.row, m), split(C.col, n), n, N, v);
}

// SMs of the current device (one block a SM: the grid of a persistent
// launch), read once per device
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

template <int BM, typename TA, typename TB, bool SPLIT>
int launch(int M, int N, int K, int splits, const GemmView& A,
           const GemmView& B, const GemmOut& C, float* ws,
           cudaStream_t stream) {
  using T = Tile<BM, TA, TB>;
  const long long units = (long long)((M + BM - 1) / BM)
                          * ((N + T::BN - 1) / T::BN) * splits;
  const int sms = sm_count();
  if (units * ((K + BK - 1) / BK) > 0x7fffffffLL || sms < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fu_gemm_kernel<BM, TA, TB, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  const unsigned grid = unsigned(units < sms ? units : sms);
  fu_gemm_kernel<BM, TA, TB, SPLIT><<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      M, N, K, splits, A, B, C, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return int(err);
  const long long threads = (long long)(M + C.zero_rows) * ((N + 3) / 4);
  const unsigned blocks = unsigned((threads + REDUCE_THREADS - 1) / REDUCE_THREADS);
  const auto reduce = C.bf16 ? split_reduce_kernel<true> : split_reduce_kernel<false>;
  reduce<<<blocks, REDUCE_THREADS, 0, stream>>>(M, N, splits, ws, C);
  return int(cudaGetLastError());
}

// the instances: A and B fp32, or one of them bf16 (x or a stored stage
// into the B of a DFT stage; the stored spectrum into the conv stage's A,
// at BM = A_BF16_BM only, which the plan gives that stage: N = 2 C' tiles
// best at 128 rows for the served widths, and fewer instances build
// faster); the output fp32, or bf16 where A is fp32 (a stored DFT stage)
template <int BM, typename TA, typename TB>
int launch_types(int M, int N, int K, int splits, const GemmView& A,
                 const GemmView& B, const GemmOut& C, float* ws,
                 cudaStream_t stream) {
  if (splits > 1) return launch<BM, TA, TB, true>(M, N, K, splits, A, B, C, ws, stream);
  return launch<BM, TA, TB, false>(M, N, K, 1, A, B, C, ws, stream);
}

template <int BM>
int launch_bm(int M, int N, int K, int splits, const GemmView& A,
              const GemmView& B, const GemmOut& C, float* ws,
              cudaStream_t stream) {
  if (A.bf16) {
    if constexpr (BM == A_BF16_BM)
      if (!C.bf16)
        return launch_types<BM, bf16, float>(M, N, K, splits, A, B, C, ws, stream);
    return int(cudaErrorInvalidValue);
  }
  if (B.bf16) return launch_types<BM, float, bf16>(M, N, K, splits, A, B, C, ws, stream);
  return launch_types<BM, float, float>(M, N, K, splits, A, B, C, ws, stream);
}

}  // namespace

// One stage of the FourierUnit: out[m][n] = epilogue(sum_k A[m][k] *
// B[k][n]) on BM x (16384 / BM) tiles, bm in {16, 32, 64, 128}, each
// tile's K in `splits` (1 .. MAX_SPLITS, at most the K / 16 stages) runs
// summed through ws: splits * M * (N rounded up to 4) fp32, 16-byte
// aligned (null for splits = 1). A and B float32, or one of them bfloat16;
// C float32 or bfloat16 (float32 where A is bfloat16); indices below 2^31;
// vec operands 16-byte aligned. Returns a cudaError_t value (0 on
// success); the launches (two where splits > 1) are asynchronous on
// `stream`.
extern "C" int lama_fu_gemm(int M, int N, int K, int bm, int splits,
                            const GemmView* A, const GemmView* B,
                            const GemmOut* C, void* ws, void* stream) {
  if ((A->bf16 && B->bf16) || M < 1 || N < 1 || K < 1 || C->zero_rows < 0 ||
      C->zero_rows > MAX_ZERO_ROWS || splits < 1 || splits > MAX_SPLITS ||
      splits > (K + BK - 1) / BK ||
      (splits > 1 && (!ws || reinterpret_cast<uintptr_t>(ws) % 16)))
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<float*>(ws);
  switch (bm) {
    case 16: return launch_bm<16>(M, N, K, splits, *A, *B, *C, w, s);
    case 32: return launch_bm<32>(M, N, K, splits, *A, *B, *C, w, s);
    case 64: return launch_bm<64>(M, N, K, splits, *A, *B, *C, w, s);
    case 128: return launch_bm<128>(M, N, K, splits, *A, *B, *C, w, s);
    default: return int(cudaErrorInvalidValue);
  }
}
