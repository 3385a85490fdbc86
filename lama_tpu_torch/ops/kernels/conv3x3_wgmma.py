"""The bf16 3x3 stride-1 reflect conv on wgmma: weight packing, the
kernel's plan in Python, and its launch.

One CUDA kernel (lama_tpu_torch/csrc/conv3x3_wgmma.cu) serves the bf16
paths of two wrappers, which compute the same function at different channel
counts:

  halo_conv.py::halo_conv3x3_reflect    <- lama_tpu/ops/pallas/halo_conv.py:53
  reflect_conv.py::reflect_conv3x3_taps <- lama_tpu/ops/pallas/reflect_conv.py:465

Their fp32 paths keep the SIMT kernels of halo_conv.cu and reflect_conv.cu.
The constants below are the kernel's (tests/test_torch_kernels.py checks
that the source agrees), and `a_descriptor` / `b_descriptor` give the
shared-memory matrix descriptors it builds, so that the CPU tests can replay
the kernel's plan (tiles, reflect-mapped halo, packed weights, per-tap
descriptors) in numpy against the plain conv.
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
CHUNK_C = 32                # input channels per pipeline stage
GROUP_C = 8                 # channels per 16-byte core-matrix row
STAGES = 2
BYTES = 2                   # bf16


def reflect_index(i, n):
    """The kernel's reflect_idx: torch 'reflect' for |overhang| < n, then a
    clamp (only halo pixels of outputs that are never stored need it)."""
    i = abs(i)
    i = 2 * (n - 1) - i if i >= n else i
    return min(max(i, 0), n - 1)


def tile_origins(h: int, w: int):
    """(row, col) of each block's output tile, in blockIdx.x order."""
    return [(r, c) for r in range(0, h, TILE_H) for c in range(0, w, TILE_W)]


def a_descriptor(sub_row: int, sub_col: int, tap: int, kstep: int):
    """(start, LBO, SBO) in bytes, from the stage's halo, of the A operand
    (64 pixels x 16 channels) of one m64 sub-tile at one tap and 16-channel
    step. Halo layout: [8-channel group][halo pixel][8 channels]; row m of
    A is output pixel (8 sub_row + m // 8, 8 sub_col + m % 8) of the tile."""
    ky, kx = divmod(tap, 3)
    pixel = (SUB * sub_row + ky) * HALO_W + SUB * sub_col + kx
    return ((2 * kstep * HALO_H * HALO_W + pixel) * GROUP_C * BYTES,
            HALO_H * HALO_W * GROUP_C * BYTES, HALO_W * GROUP_C * BYTES)


def b_descriptor(tap: int, kstep: int):
    """(start, LBO, SBO) in bytes, from the stage's weights, of the B
    operand (128 output channels x 16 input channels) at one tap and step.
    Weight layout: [tap][8-channel group][128 output channels][8]."""
    groups = CHUNK_C // GROUP_C
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
def _launcher():
    """lama_conv3x3_wgmma of the built library (built at the first call)."""
    fn = _build.load('conv3x3_wgmma').lama_conv3x3_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def conv3x3_reflect_bf16(x, weight, bias=None):
    """Launch the kernel: x a channels-last bf16 CUDA tensor, an OIHW
    weight and an optional bias on its device; returns the channels-last
    bf16 output. The caller checks the envelope."""
    b, c, h, w = x.shape
    c_out = weight.shape[0]
    wk = pack_conv3x3_weight(weight)
    bk = None if bias is None else bias.float().contiguous()
    out = torch.empty((b, c_out, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(x.data_ptr(), wk.data_ptr(),
                          None if bk is None else bk.data_ptr(),
                          out.data_ptr(), b, h, w, c, c_out, stream)
    if err != 0:
        raise RuntimeError(f'conv3x3_wgmma: CUDA launch failed with error {err}')
    return out
