"""The bf16 3x3 reflect conv on wgmma, stride 1 and 2: weight packing, the
kernel's plan in Python, and its launch.

One CUDA source (lama_tpu_torch/csrc/conv3x3_wgmma.cu), one kernel
templated on the stride, serves the bf16 paths of every 3x3 reflect-conv
wrapper, which compute the same function at different channel counts and
strides:

  halo_conv.py::halo_conv3x3_reflect    <- lama_tpu/ops/pallas/halo_conv.py:53
  reflect_conv.py::reflect_conv3x3_taps <- lama_tpu/ops/pallas/reflect_conv.py:465
  reflect_conv.py::reflect_conv3x3_cols <- lama_tpu/ops/pallas/reflect_conv.py:130
  reflect_conv.py::reflect_down_conv3x3 <- lama_tpu/ops/pallas/reflect_conv.py:230
                                           (stride 2)

Their fp32 paths are the register-tiled SIMT kernel of conv3x3_simt.cu, at
stride 1 and 2.
The constants below are the kernel's (tests/test_torch_kernels.py checks
that the source agrees), and `a_descriptor` / `b_descriptor` give the
shared-memory matrix descriptors it builds, so that the CPU tests can replay
the kernel's plan (tiles, reflect-mapped halo, the width-pair halo at stride
2, packed weights, per-tap descriptors) in numpy against the plain conv.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

TILE_H = TILE_W = 16        # output pixels per block (M = 256)
SUB = 8                     # an m64 sub-tile: 8 x 8 output pixels
HALO_H, HALO_W = TILE_H + 2, TILE_W + 2
BLOCK_N = 128               # output channels per block
CHUNK_C = 32                # input channels per pipeline stage; and per
                            # chunk of the packed weights
GROUP_C = 8                 # channels per 16-byte core-matrix row
STAGES = 2
# stride 2: the halo in width pairs (input columns 2p and 2p + 1 are slots 0
# and 1 of pair p), 2 TILE_H + 1 rows by TILE_W + 1 pairs; three stages of
# 16 channels (two stages of 32 would not fit the 227 KB)
S2_HALO_H, S2_HALO_W = 2 * TILE_H + 1, TILE_W + 1
S2_CHUNK_C = 16
S2_STAGES = 3
BYTES = 2                   # bf16
SMEM_LIMIT = 232448         # shared memory of one block, bytes


def chunk_c(stride: int = 1) -> int:
    """Input channels per pipeline stage at `stride`."""
    return CHUNK_C if stride == 1 else S2_CHUNK_C


def halo_shape(stride: int = 1):
    """(rows, columns) of a stage's halo at `stride`; columns are pixels at
    stride 1, width pairs at stride 2."""
    return (HALO_H, HALO_W) if stride == 1 else (S2_HALO_H, S2_HALO_W)


def stage_bytes(stride: int = 1) -> int:
    """Bytes of one pipeline stage: the halo's group planes (stride slots x
    8-channel groups, 16 B a pixel) and the chunk's weights."""
    hh, hw = halo_shape(stride)
    c = chunk_c(stride)
    return stride * (c // GROUP_C) * hh * hw * 16 + 9 * c * BLOCK_N * BYTES


def reflect_index(i, n):
    """The kernel's reflect_idx: torch 'reflect' for |overhang| < n, then a
    clamp (only halo pixels of outputs that are never stored need it)."""
    i = abs(i)
    i = 2 * (n - 1) - i if i >= n else i
    return min(max(i, 0), n - 1)


def tile_origins(h: int, w: int, stride: int = 1):
    """(row, col) of each block's output tile, in blockIdx.x order, for an
    h x w input (its output is h // stride x w // stride)."""
    ho, wo = h // stride, w // stride
    return [(r, c) for r in range(0, ho, TILE_H) for c in range(0, wo, TILE_W)]


def halo_source(r0: int, c0: int, h: int, w: int, stride: int = 1):
    """The reflect-mapped source of the halo of the output tile at (r0,
    c0), as the kernel's copies address it: (input row of each halo row,
    input column of each halo column for each slot)."""
    hh, hw = halo_shape(stride)
    rows = [reflect_index(stride * r0 - 1 + i, h) for i in range(hh)]
    cols = [[reflect_index(stride * (c0 - 1 + p) + slot, w) for p in range(hw)]
            for slot in range(stride)]
    return rows, cols


def a_descriptor(sub_row: int, sub_col: int, tap: int, kstep: int,
                 stride: int = 1):
    """(start, LBO, SBO) in bytes, from the stage's halo, of the A operand
    (64 pixels x 16 channels) of one m64 sub-tile at one tap and 16-channel
    step. Halo layout: [slot * groups + 8-channel group][halo pixel][8
    channels]; row m of A is output pixel (8 sub_row + m // 8, 8 sub_col +
    m % 8) of the tile, which reads halo row stride * (8 sub_row + m // 8)
    + ky. Stride 1: halo column 8 sub_col + m % 8 + kx. Stride 2: pair
    column 8 sub_col + m % 8 + (kx == 0 ? 0 : 1) of slot
    (kx == 1 ? 0 : 1)."""
    ky, kx = divmod(tap, 3)
    hh, hw = halo_shape(stride)
    groups = chunk_c(stride) // GROUP_C
    col, slot = (kx, 0) if stride == 1 else ((kx + 1) // 2, (kx + 1) % 2)
    pixel = (stride * SUB * sub_row + ky) * hw + SUB * sub_col + col
    plane = slot * groups + 2 * kstep
    return ((plane * hh * hw + pixel) * GROUP_C * BYTES,
            hh * hw * GROUP_C * BYTES, stride * hw * GROUP_C * BYTES)


def b_descriptor(tap: int, kstep: int, stride: int = 1):
    """(start, LBO, SBO) in bytes, from the stage's weights, of the B
    operand (128 output channels x 16 input channels) at one tap and step.
    Weight layout: [tap][8-channel group][128 output channels][8]."""
    groups = chunk_c(stride) // GROUP_C
    return ((tap * groups + 2 * kstep) * BLOCK_N * GROUP_C * BYTES,
            BLOCK_N * GROUP_C * BYTES, GROUP_C * GROUP_C * BYTES)


def pack_conv3x3_weight(weight, dtype=torch.bfloat16):
    """OIHW (C_out, C, 3, 3) -> the kernel's flat weight image
    [n tile][channel chunk][tap][8-channel group][128 output channels][8],
    C and C_out zero-filled to whole chunks and tiles. A plain function of
    the weight, run on every call (no cache)."""
    co, c = weight.shape[:2]
    nt, chunks = -(-co // BLOCK_N), -(-c // CHUNK_C)
    groups = CHUNK_C // GROUP_C
    if (co, c) != (nt * BLOCK_N, chunks * CHUNK_C):
        weight = F.pad(weight, (0, 0, 0, 0, 0, chunks * CHUNK_C - c,
                                0, nt * BLOCK_N - co))
    out = torch.empty((nt, chunks, 3, 3, groups, BLOCK_N, GROUP_C),
                      dtype=dtype, device=weight.device)
    # one strided copy casts and relayouts: out viewed as
    # (nt, n, chunk, group, 8, ky, kx) is the OIHW weight reshaped
    out.permute(0, 5, 1, 4, 6, 2, 3).copy_(
        weight.reshape(nt, BLOCK_N, chunks, groups, GROUP_C, 3, 3))
    return out.reshape(-1)


@functools.lru_cache(maxsize=None)
def _launcher(symbol):
    """`symbol` of the built library (built at the first call):
    lama_conv3x3_wgmma (stride 1) or lama_conv3x3_s2_wgmma (stride 2)."""
    fn = getattr(_build.load('conv3x3_wgmma'), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


LAUNCHERS = {1: 'lama_conv3x3_wgmma', 2: 'lama_conv3x3_s2_wgmma'}


def conv3x3_reflect_bf16(x, weight, bias=None, stride=1):
    """Launch the kernel: x a channels-last bf16 CUDA tensor, an OIHW
    weight and an optional bias on its device; returns the channels-last
    bf16 output (H and W even at stride 2). The caller checks the
    envelope."""
    b, c, h, w = x.shape
    c_out = weight.shape[0]
    wk = pack_conv3x3_weight(weight)
    bk = None if bias is None else bias.float().contiguous()
    out = torch.empty((b, c_out, h // stride, w // stride), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    symbol = LAUNCHERS[stride]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(symbol)(x.data_ptr(), wk.data_ptr(),
                                None if bk is None else bk.data_ptr(),
                                out.data_ptr(), b, h, w, c, c_out, stream)
    if err != 0:
        raise RuntimeError(f'{symbol}: CUDA launch failed with error {err}')
    return out
