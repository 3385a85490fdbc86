"""The generators' 7x7 stem: reflect pad 3, then a 7x7 stride-1 conv of a
few input channels into up to 64 output channels, in fp32 and bf16. Its
envelope, plan, weight packing and launch.

One CUDA source (lama_tpu_torch/csrc/stem_conv.cu) takes kernel 7's
(halo_conv.py::halo_conv_reflect_tiled <- lama_tpu/ops/pallas/
halo_conv.py:158) shapes inside `supported`: k = 7, stride 1, C <= 8,
C_out a multiple of 16 up to 64. That is the stem of big-lama (4 -> 64, no
bias) and of big-lama-regular (4 -> 64, bias). Kernel 7's other shapes
stay on csrc/halo_conv.cu.

The kernel is a persistent grid walking tiles of TILE_H x TILE_W output
pixels by all C_out channels, with the packed weights staged once per block
and each tile's reflect-mapped halo (HALO_H x HALO_W pixels of `pitch(C)`
channels, the last column zeros) brought in by a cp.async ring while the
previous tile computes. fp32 runs a register tile of 8 pixels x 8 channels
a thread on the FMA units; bf16 runs mma.sync m16n8k16 with its A operand
read straight from the halo. The constants below are the kernel's
(tests/test_torch_stem_conv.py checks that the source agrees), and the
fragment maps (`a_fragment`, `b_fragment`, `d_fragment`) give the
addresses its bf16 loop reads, so that the CPU tests can replay it in
numpy against the unfold of the reflect-padded input.
"""
import ctypes
import functools

import torch

from . import _build
from .conv3x3_wgmma import reflect_index

KS, PAD = 7, 3              # kernel size, reflect pad
TILE_H, TILE_W = 8, 32      # output pixels per tile (256)
THREADS = 256
CO_MAX = 64                 # output channels per tile (weights padded to it)
RING = 2                    # halo stages
HALO_H = TILE_H + KS - 1    # 14
HALO_W = TILE_W + KS        # 39: the 38 the taps read + one zero pixel
MAX_C = 8


def supported(h: int, w: int, c: int, c_out: int, k: int = KS,
              s: int = 1) -> bool:
    """7x7, stride 1, 1 <= C <= 8, C_out a multiple of 16 in [16, 64], and
    an input a reflect pad of 3 can take (H, W > 3)."""
    return (k == KS and s == 1 and 1 <= c <= MAX_C and c_out % 16 == 0
            and 16 <= c_out <= CO_MAX and h > PAD and w > PAD)


def pitch(c: int) -> int:
    """Channels a halo pixel holds: 4 for C <= 4, else 8 (zero-filled)."""
    return 4 if c <= 4 else 8


def ky_width(p: int) -> int:
    """bf16: the k of one ky row, 7 * pitch padded to a multiple of 16."""
    return -(-KS * p // 16) * 16


def weight_pitch(p: int) -> int:
    """bf16: elements of one output channel's packed weight row (the 7 ky
    rows + 8, which keeps the B loads on distinct banks)."""
    return KS * ky_width(p) + 8


def halo_row(p: int) -> int:
    """Elements of one halo row in shared memory."""
    return HALO_W * p


def out_tiles(b: int, h: int, w: int):
    """(image, row, column) origin of each output tile, in tile order."""
    return [(i, r, c) for i in range(b) for r in range(0, h, TILE_H)
            for c in range(0, w, TILE_W)]


def halo_source(r0: int, c0: int, h: int, w: int):
    """The input row of each halo row and the input column of each halo
    column of the tile at (r0, c0); None for the last column, which the
    kernel zero-fills."""
    return ([reflect_index(r0 - PAD + i, h) for i in range(HALO_H)],
            [reflect_index(c0 - PAD + j, w) for j in range(HALO_W - 1)]
            + [None])


def a_fragment(lane: int, reg: int, step: int, m_tile: int, p: int):
    """bf16 A operand: (m, k, offset) of the low half of register `reg` of
    `lane` at k-step `step` of one ky row, m-tile `m_tile` of the warp's
    32 pixels: m the pixel (column in the tile), k in [0, ky_width(p)),
    and the element offset from the start of the ky's halo row that the
    kernel's 32-bit load reads (the high half is k + 1, offset + 1). For
    k < 7 p, k = kx * p + c; past that the weights are zero."""
    g, t = lane // 4, lane % 4
    m = m_tile * 16 + g + (8 if reg % 2 else 0)
    k = step * 16 + 2 * t + (8 if reg >= 2 else 0)
    return m, k, m * p + k


def b_fragment(lane: int, reg: int, step: int, n_tile: int, ky: int, p: int):
    """bf16 B operand: (k, n, offset) of the low half of register `reg` of
    `lane` at k-step `step` of row ky: k within the ky row, n the output
    channel, offset its element in the packed weights (`pack_weight`); the
    high half is k + 1, offset + 1."""
    g, t = lane // 4, lane % 4
    k = step * 16 + 2 * t + (8 if reg else 0)
    n = n_tile * 8 + g
    return k, n, n * weight_pitch(p) + ky * ky_width(p) + k


def d_fragment(lane: int, reg: int):
    """(m, n) within an m16n8 tile of accumulator `reg` of `lane`."""
    g, t = lane // 4, lane % 4
    return g + (8 if reg >= 2 else 0), 2 * t + reg % 2


def pack_weight(weight, dtype):
    """OIHW (C_out, C, 7, 7) -> the kernel's flat weight image in `dtype`,
    C zero-filled to pitch(C) and C_out to CO_MAX: fp32 [ky][kx][c][n];
    bf16 [n][weight_pitch] with element ky * ky_width + kx * pitch + c, the
    padded k and the row's tail zero. A plain function of the weight, run
    on every call (no cache)."""
    co, c = weight.shape[:2]
    p = pitch(c)
    if dtype == torch.float32:
        out = weight.new_zeros((KS, KS, p, CO_MAX), dtype=dtype)
        out[:, :, :c, :co] = weight.permute(2, 3, 1, 0)
        return out.reshape(-1)
    kw = ky_width(p)
    out = weight.new_zeros((CO_MAX, weight_pitch(p)), dtype=dtype)
    taps = out[:co, :KS * kw].view(co, KS, kw)[:, :, :KS * p]
    taps.view(co, KS, KS, p)[..., :c] = weight.permute(0, 2, 3, 1)
    return out.reshape(-1)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# lama_stem_conv(x, wpk, bias, out, B, H, W, C, Co, dtype, stream)
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _launcher():
    """lama_stem_conv of the built library (built at the first call)."""
    fn = _build.load('stem_conv').lama_stem_conv
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    return fn


def stem_conv_reflect(x, weight, bias=None):
    """Launch the kernel: x a channels-last fp32 or bf16 CUDA tensor inside
    `supported`, an OIHW weight and an optional bias on its device; returns
    the channels-last output in x's dtype (fp32 accumulation, bf16 rounded
    once at the store). The caller checks the envelope."""
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
        raise RuntimeError(f'lama_stem_conv: CUDA launch failed with error '
                           f'{err}')
    return out
