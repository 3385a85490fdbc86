"""The fp32 3x3 reflect conv, stride 1 and 2: weight packing, the kernel's
plan in Python, its split over K, and its launch.

One CUDA source (lama_tpu_torch/csrc/conv3x3_simt.cu), a register-tiled
SIMT implicit GEMM templated on the stride, serves the fp32 paths of every
3x3 reflect-conv wrapper:

  reflect_conv.py::reflect_conv3x3_cols <- lama_tpu/ops/pallas/reflect_conv.py:130
  reflect_conv.py::reflect_conv3x3_taps <- lama_tpu/ops/pallas/reflect_conv.py:465
  halo_conv.py::halo_conv3x3_reflect    <- lama_tpu/ops/pallas/halo_conv.py:53
                                           (stride 1, any C and C_out)
  reflect_conv.py::reflect_down_conv3x3 <- lama_tpu/ops/pallas/reflect_conv.py:230
                                           (stride 2)

Their bf16 paths are conv3x3_wgmma.py's. The constants below are the
kernel's (tests/test_torch_kernels.py checks that the source agrees), and
the plan functions give the addresses it computes (tile origins, the
reflect-mapped halo, each thread's pixels and channels, the shared-memory
offsets of its operands, the packed weights, each split's run of chunks),
so that the CPU tests can replay the kernel in numpy against the plain
conv. `split_count` is the rule that splits K over up to MAX_SPLITS blocks
per output tile where a stride-1 grid fills less than one wave of the
card's SMs.
"""
import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build
from .conv3x3_wgmma import reflect_index

TILE_H, TILE_W = 8, 16      # output pixels per block (M = 128)
BLOCK_N = 128               # output channels per block
THREADS = 256               # 16 pixel groups x 16 channel groups
CHUNK_C = 8                 # input channels per pipeline stage (stride 1)
STAGES = 4
S2_CHUNK_C = 8              # (stride 2: the 17 x 33 halo)
S2_STAGES = 3
PITCH_PAD = 4               # a halo pixel's pitch is its chunk + 4 floats
SMEM_LIMIT = 232448         # shared memory of one block, bytes
MAX_SPLITS = 4              # K splits of a stride-1 grid under one wave
SPLIT_SLACK = 0.05          # take the fewest splits within 5% of the best
BYTES = 4                   # fp32


def chunk_c(stride: int = 1) -> int:
    """Input channels per pipeline stage at `stride`."""
    return CHUNK_C if stride == 1 else S2_CHUNK_C


def stages(stride: int = 1) -> int:
    return STAGES if stride == 1 else S2_STAGES


def pitch(stride: int = 1) -> int:
    """Floats per halo pixel in shared memory."""
    return chunk_c(stride) + PITCH_PAD


def halo_shape(stride: int = 1):
    """(rows, columns) of a stage's halo: (tile - 1) * stride + 3."""
    return (stride * (TILE_H - 1) + 3, stride * (TILE_W - 1) + 3)


def halo_floats(stride: int = 1) -> int:
    hh, hw = halo_shape(stride)
    return hh * hw * pitch(stride)


def weight_floats(stride: int = 1) -> int:
    """Floats of one stage's (and one packed chunk's) weights."""
    return 9 * chunk_c(stride) * BLOCK_N


def stage_bytes(stride: int = 1) -> int:
    return (halo_floats(stride) + weight_floats(stride)) * BYTES


def out_size(n: int, stride: int) -> int:
    """Output rows (columns) of a reflect-padded 3x3 conv of n rows."""
    return (n - 1) // stride + 1


def tile_origins(h: int, w: int, stride: int = 1):
    """(row, col) of each block's output tile, in blockIdx.x order."""
    return [(r, c) for r in range(0, out_size(h, stride), TILE_H)
            for c in range(0, out_size(w, stride), TILE_W)]


def halo_source(r0: int, c0: int, h: int, w: int, stride: int = 1):
    """The reflect-mapped source of the halo of the output tile at (r0,
    c0): (input row of each halo row, input column of each halo
    column)."""
    hh, hw = halo_shape(stride)
    return ([reflect_index(stride * r0 - 1 + i, h) for i in range(hh)],
            [reflect_index(stride * c0 - 1 + j, w) for j in range(hw)])


def thread_tile(tid: int):
    """(output row, first output column, channel group) of thread `tid`
    within its block's tile: its 8 pixels are that row's columns col ..
    col + 7, its channels tn * 4 + 0..3 and 64 + tn * 4 + 0..3."""
    lane, warp = tid % 32, tid // 32
    tn = (warp % 2) * 8 + lane % 8
    pg = (warp // 2) * 4 + lane // 8
    return pg % TILE_H, (pg // TILE_H) * 8, tn


def thread_channels(tn: int):
    return [tn * 4 + e for e in range(4)] + [64 + tn * 4 + e for e in range(4)]


def a_offset(prow: int, col: int, tap: int, c: int, stride: int = 1) -> int:
    """Float offset, from the stage's start, of input channel c (within the
    chunk) of the halo pixel that output pixel (prow, col) of the tile reads
    at tap (ky, kx)."""
    ky, kx = divmod(tap, 3)
    hw = halo_shape(stride)[1]
    return ((stride * prow + ky) * hw + stride * col + kx) * pitch(stride) + c


def b_offset(tap: int, c: int, n: int, stride: int = 1) -> int:
    """Float offset, from the stage's start, of the weight of input
    channel c (within the chunk), output channel n (within the block) at
    `tap`: the weights follow the halo as [tap][channel][128]."""
    return halo_floats(stride) + (tap * chunk_c(stride) + c) * BLOCK_N + n


def grid_blocks(b: int, h: int, w: int, c_out: int, stride: int = 1) -> int:
    """Blocks of the unsplit grid: output tiles x N tiles x batch."""
    return (len(tile_origins(h, w, stride)) * -(-c_out // BLOCK_N) * b)


def split_count(blocks: int, sms: int, chunks: int) -> int:
    """The number s of blocks that share one output tile's walk over K (its
    `chunks` input-channel chunks), for a stride-1 grid of `blocks` blocks
    on a card of `sms` SMs (one block a SM). Split only a grid under one
    wave (blocks < sms), into at most MAX_SPLITS runs of at least STAGES
    chunks each (a shorter run spends most of its time filling the ring);
    among those s, the time in waves of one unsplit block's work,
    ceil(blocks * s / sms) / s, is least at some s*: take the fewest splits
    within SPLIT_SLACK of it."""
    if blocks >= sms:
        return 1
    cands = [s for s in range(1, MAX_SPLITS + 1)
             if s == 1 or chunks >= STAGES * s]
    waves = {s: math.ceil(blocks * s / sms) / s for s in cands}
    best = min(waves.values())
    return min(s for s in cands if waves[s] <= best * (1 + SPLIT_SLACK))


def split_chunks(split: int, splits: int, chunks: int):
    """[first, end) of the chunks that split `split` of `splits` walks, as
    the kernel computes them."""
    return split * chunks // splits, (split + 1) * chunks // splits


def plan_splits(b: int, h: int, w: int, c: int, c_out: int, sms: int) -> int:
    """split_count for a stride-1 call of this shape on `sms` SMs."""
    return split_count(grid_blocks(b, h, w, c_out), sms, -(-c // CHUNK_C))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index` (cached per device)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def weight_offset(n_tile: int, chunk: int, chunks: int, stride: int = 1) -> int:
    """Float offset in the packed weights of one stage's weights."""
    return (n_tile * chunks + chunk) * weight_floats(stride)


def pack_conv3x3_weight(weight, stride=1, ck=None):
    """OIHW (C_out, C, 3, 3) -> the kernel's flat fp32 weight image [n
    tile][channel chunk][tap][ck channels][128 output channels], ck =
    chunk_c(stride) unless given, C and C_out zero-filled to whole chunks
    and tiles. A plain function of the weight, run on every call (no
    cache)."""
    co, c = weight.shape[:2]
    ck = ck or chunk_c(stride)
    nt, chunks = -(-co // BLOCK_N), -(-c // ck)
    if (co, c) != (nt * BLOCK_N, chunks * ck):
        weight = F.pad(weight, (0, 0, 0, 0, 0, chunks * ck - c,
                                0, nt * BLOCK_N - co))
    out = torch.empty((nt, chunks, 3, 3, ck, BLOCK_N), dtype=torch.float32,
                      device=weight.device)
    # out viewed as (nt, n, chunk, channel, ky, kx) is the OIHW weight
    out.permute(0, 5, 1, 4, 2, 3).copy_(
        weight.reshape(nt, BLOCK_N, chunks, ck, 3, 3))
    return out.reshape(-1)


LAUNCHERS = {1: 'lama_conv3x3_simt', 2: 'lama_conv3x3_s2_simt'}


# both launchers: (x, wpk, bias, out, ws, B, H, W, C, C_out, splits, stream)
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _launcher(symbol):
    """`symbol` of the built library (built at the first call)."""
    fn = getattr(_build.load('conv3x3_simt'), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    return fn


def workspace(splits, b, ho, wo, c_out, device):
    """The partial sums of a split launch: (splits, B, Ho, Wo, C_out padded
    to BLOCK_N) fp32 from the caching allocator; None unsplit."""
    if splits == 1:
        return None
    return torch.empty((splits, b, ho, wo, -(-c_out // BLOCK_N) * BLOCK_N),
                       dtype=torch.float32, device=device)


def conv3x3_reflect_fp32(x, weight, bias=None, stride=1, splits=None):
    """Launch the kernel: x a channels-last fp32 CUDA tensor, an OIHW
    weight and an optional bias on its device; returns the channels-last
    fp32 output, (H - 1) // stride + 1 x (W - 1) // stride + 1. At stride
    1, K is split `splits` ways (default: plan_splits on x's card). The
    caller checks the envelope."""
    b, c, h, w = x.shape
    c_out = weight.shape[0]
    if splits is None:
        splits = (1 if stride != 1 else
                  plan_splits(b, h, w, c, c_out, sm_count(x.device.index)))
    wk = pack_conv3x3_weight(weight, stride)
    bk = None if bias is None else bias.float().contiguous()
    ho, wo = out_size(h, stride), out_size(w, stride)
    out = torch.empty((b, c_out, ho, wo), dtype=torch.float32,
                      device=x.device, memory_format=torch.channels_last)
    ws = workspace(splits, b, ho, wo, c_out, x.device)
    symbol = LAUNCHERS[stride]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(symbol)(x.data_ptr(), wk.data_ptr(),
                                None if bk is None else bk.data_ptr(),
                                out.data_ptr(),
                                None if ws is None else ws.data_ptr(),
                                b, h, w, c, c_out, splits, stream)
    if err != 0:
        raise RuntimeError(f'{symbol}: CUDA launch failed with error {err}')
    return out
