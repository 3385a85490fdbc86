"""The generators' 7x7 head: reflect pad 3, then a 7x7 stride-1 conv of up
to 128 input channels into at most 8 output channels, in fp32 and bf16.
Its plan, weight packing, bf16 fragment maps and launch.

Kernel 5 (reflect_conv.py::reflect_out_conv7x7 <- lama_tpu/ops/pallas/
reflect_conv.py:327) runs lama_tpu_torch/csrc/reflect_conv.cu in both
dtypes, inside its envelope (reflect_conv.py::reflect_out_conv7x7_supported:
C_out <= 8, C <= 128, C % 8 == 0, H, W >= 8): big-lama's and
big-lama-regular's 64 -> 3 head.

The kernel is a persistent grid walking (tile, channel chunk) items with
the packed weights staged once per block where they fit (`layout`) and
each chunk's reflect-mapped halo brought in by a cp.async ring while the
previous one computes. fp32 runs a 2-D register tile of 2 x 4 pixels x
C_out a thread on the FMA units, the halo 4 channels (16 bytes) a
swizzled pixel; bf16 runs
mma.sync m16n8k16 with N = (kx, co), K = (ky, c), M = 16 halo columns,
its A operand read by ldmatrix straight from the swizzled NHWC halo, and
sums the kx shifts after all of K. The constants below are the kernel's
(tests/test_torch_kernels.py checks that the source agrees), and the
fragment maps give the addresses its bf16 loop reads, so that the CPU
tests can replay it in numpy against the plain conv.
"""
import ctypes
import functools

import torch

from . import _build
from .conv3x3_wgmma import reflect_index

KS, PAD = 7, 3              # kernel size, reflect pad
THREADS = 256
WARPS = THREADS // 32
MAX_CO, MAX_C, MIN_SIDE = 8, 128, 8
BIAS_BYTES = MAX_CO * 4
BLOCK_SMEM = 232448
# fp32: a thread's 2 x 4 pixels, 16 x 16 threads, 4 channels (a 16-byte
# halo pixel) a stage
F_RH, F_RW, F_TX, F_TY = 2, 4, 16, 16
F_TILE_H, F_TILE_W = F_TY * F_RH, F_TX * F_RW          # 32 x 64
F_HALO_H, F_HALO_W = F_TILE_H + KS - 1, F_TILE_W + KS - 1
F_CK, F_RING = 4, 3
# bf16: 4 m-tiles of 16 halo columns a warp row, 16 channels a stage
B_MT = 4
B_HALO_W = 16 * B_MT        # 64
B_TILE_W = B_HALO_W - KS + 1    # 58
B_CK = 16
B_PIX_BYTES = B_CK * 2
B_ROW_BYTES = B_HALO_W * B_PIX_BYTES
B_RING = 3
B_FRAG_BYTES = 32 * 8       # one B fragment: 8 bytes a lane, lane order
D_ROWS = 32                 # bf16 epilogue: the ring of D rows a warp


def _bf16(dtype) -> bool:
    return dtype == torch.bfloat16


def n_tiles(c_out: int) -> int:
    """bf16: the n-tiles of 8 that N = (kx, co), 7 * C_out columns, takes."""
    return -(-KS * c_out // 8)


def rows_per_warp(c_out: int) -> int:
    """bf16: output rows a warp owns (2 where the accumulators allow)."""
    return 2 if n_tiles(c_out) <= 3 else 1


def tile(dtype, c_out: int):
    """(rows, columns) of an output tile."""
    if _bf16(dtype):
        return WARPS * rows_per_warp(c_out), B_TILE_W
    return F_TILE_H, F_TILE_W


def chunk_channels(dtype) -> int:
    return B_CK if _bf16(dtype) else F_CK


def kxp(c_out: int) -> int:
    """fp32: floats of one (c, ky) weight row, 7 * C_out padded to 4."""
    return -(-KS * c_out // 4) * 4


def chunk_weight_bytes(dtype, c_out: int) -> int:
    if _bf16(dtype):
        return KS * n_tiles(c_out) * B_FRAG_BYTES
    return F_CK * KS * kxp(c_out) * 4


def halo_bytes(dtype, c_out: int) -> int:
    if _bf16(dtype):
        return (tile(dtype, c_out)[0] + KS - 1) * B_ROW_BYTES
    return F_HALO_H * F_HALO_W * 16


def d_pitch(c_out: int) -> int:
    """bf16 epilogue: floats of one D row in the warp's ring (odd)."""
    return n_tiles(c_out) * 8 + 1


def epilogue_warp_bytes(dtype, c_out: int) -> int:
    """bf16: a warp's ring of D_ROWS D rows, then its staged bf16 output
    row (up to 7 elements of 16-byte phase first); fp32: none."""
    if not _bf16(dtype):
        return 0
    return -(-(D_ROWS * d_pitch(c_out) * 4 + (7 + B_TILE_W * c_out) * 2)
             // 16) * 16


def epilogue_ranges():
    """bf16: the outputs x in [x0, x1) summed after each m-tile's D rows
    are staged: those whose 7 D rows x .. x + 6 then all are."""
    return [(0 if mt == 0 else 16 * mt - KS + 1,
             B_TILE_W if mt == B_MT - 1 else 16 * mt + 16 - KS + 1)
            for mt in range(B_MT)]


def layout(dtype, c: int, c_out: int) -> dict:
    """The kernel's shared-memory layout at C input channels: the weights
    staged once (`once`) where they fit beside the ring, else each stage
    carries its chunk's; then the bias, the ring, the bf16 epilogue."""
    chunks = -(-c // chunk_channels(dtype))
    ring = B_RING if _bf16(dtype) else F_RING
    epi_warp = epilogue_warp_bytes(dtype, c_out)
    for once in (True, False):
        w_all = chunks * chunk_weight_bytes(dtype, c_out) if once else 0
        stage_bytes = halo_bytes(dtype, c_out) + (
            0 if once else chunk_weight_bytes(dtype, c_out))
        stage = w_all + BIAS_BYTES
        epi = stage + ring * stage_bytes
        total = epi + WARPS * epi_warp
        if total <= BLOCK_SMEM:
            break
    return dict(once=once, bias=w_all, stage=stage, stage_bytes=stage_bytes,
                epi=epi, total=total)


def out_tiles(dtype, c_out: int, b: int, h: int, w: int):
    """(image, row, column) origin of each output tile, in tile order."""
    th, tw = tile(dtype, c_out)
    return [(i, r, c) for i in range(b) for r in range(0, h, th)
            for c in range(0, w, tw)]


def halo_source(dtype, c_out: int, r0: int, c0: int, h: int, w: int):
    """The input row of each halo row and the input column of each halo
    column of the tile at (r0, c0)."""
    th, _ = tile(dtype, c_out)
    cols = B_HALO_W if _bf16(dtype) else F_HALO_W
    return ([reflect_index(r0 - PAD + i, h) for i in range(th + KS - 1)],
            [reflect_index(c0 - PAD + j, w) for j in range(cols)])


def f_unit(px: int) -> int:
    """fp32 halo: the 16-byte unit of pixel px (4 channels) in its row."""
    return px ^ ((px >> 3) & 3)


def b_unit(px: int, half: int) -> int:
    """bf16 halo: the 16-byte unit of (pixel, channel half) in its row."""
    return 2 * px + (half ^ ((px >> 2) & 1))


def ldmatrix_row(lane: int):
    """bf16 A: (pixel within the m-tile, channel half) of the 8x8-matrix
    row that `lane` addresses in the kernel's ldmatrix.x4: matrix lane // 8
    (rows 0-7 / 8-15 by bit 0, k 0-7 / 8-15 by bit 1), row lane % 8."""
    q, rr = lane // 8, lane % 8
    return rr + 8 * (q & 1), q >> 1


def a_fragment(lane: int, reg: int):
    """(m, k) of the low half of A register `reg` of `lane` in m16n8k16
    (the high half is k + 1)."""
    g, t = lane // 4, lane % 4
    return g + (8 if reg % 2 else 0), 2 * t + (8 if reg >= 2 else 0)


def b_fragment(lane: int, reg: int):
    """(k, n) of the low half of B register `reg` of `lane` (the high half
    is k + 1); `pack_weight` stores them in lane order."""
    g, t = lane // 4, lane % 4
    return 2 * t + (8 if reg else 0), g


def d_fragment(lane: int, reg: int):
    """(m, n) within an m16n8 tile of accumulator `reg` of `lane`."""
    g, t = lane // 4, lane % 4
    return g + (8 if reg >= 2 else 0), 2 * t + reg % 2


def pack_weight(weight, dtype):
    """OIHW (C_out, C, 7, 7) -> the kernel's flat weight image in `dtype`,
    chunk-major. fp32: [c][ky][kxp(C_out)], element kx * C_out + co, zero
    past 7 C_out. bf16: [chunk][ky][n-tile][lane][4], the B fragments of
    k = (c within the chunk of 16) x n = (kx, co) in `b_fragment` order,
    zero past C and past 7 C_out. A plain function of the weight, run on
    every call (no cache)."""
    co, c = weight.shape[:2]
    taps = weight.permute(1, 2, 3, 0).reshape(c, KS, KS * co)   # c, ky, (kx, co)
    if not _bf16(dtype):
        out = weight.new_zeros((c, KS, kxp(co)), dtype=dtype)
        out[:, :, :KS * co] = taps
        return out.reshape(-1)
    chunks, nt = -(-c // B_CK), n_tiles(co)
    full = weight.new_zeros((chunks * B_CK, KS, nt * 8), dtype=dtype)
    full[:c, :, :KS * co] = taps
    # [chunk][k][ky][n-tile][g] -> [chunk][ky][n-tile][g][k]
    full = full.view(chunks, B_CK, KS, nt, 8).permute(0, 2, 3, 4, 1)
    k = torch.tensor([[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
                      for t in range(4)], device=weight.device)
    return full[..., k].contiguous().reshape(-1)   # [..][g][t][e]: lane 4g + t


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# lama_reflect_out_conv7x7(x, wpk, bias, out, B, H, W, C, Co, dtype, stream)
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _launcher():
    """lama_reflect_out_conv7x7 of the built library (built at the first
    call)."""
    fn = _build.load('reflect_conv').lama_reflect_out_conv7x7
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    return fn


def head_conv_reflect(x, weight, bias=None):
    """Launch the kernel: x a channels-last fp32 or bf16 CUDA tensor inside
    the envelope, an OIHW weight and an optional bias on its device;
    returns the channels-last output in x's dtype (fp32 accumulation, the
    bias added in fp32, bf16 rounded once at the store). The caller checks
    the envelope."""
    b, c, h, w = x.shape
    c_out = weight.shape[0]
    wk = pack_weight(weight, x.dtype)
    bk = None if bias is None else bias.float().contiguous()
    out = torch.empty((b, c_out, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(x.data_ptr(), wk.data_ptr(),
                          None if bk is None else bk.data_ptr(),
                          out.data_ptr(), b, h, w, c, c_out,
                          _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError('lama_reflect_out_conv7x7: CUDA launch failed '
                           f'with error {err}')
    return out
