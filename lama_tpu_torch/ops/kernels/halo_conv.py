"""Halo convs, the reflect halo built on chip: CUDA kernels and their plain
versions.

Counterparts of the TPU kernels of lama_tpu/ops/pallas/halo_conv.py:

  halo_conv3x3_reflect     <- halo_conv3x3_reflect     (halo_conv.py:53)
  halo_conv_reflect_tiled  <- halo_conv_reflect_tiled  (halo_conv.py:158)

Each computes `F.conv2d(F.pad(x, (p,)*4, mode='reflect'), weight, bias,
stride)` with p = k // 2 on NCHW tensors (any memory format) and an OIHW
weight. halo_conv3x3_reflect is the 3x3 stride-1 conv of any channel counts
(on the pix2pixHD GlobalGenerator's path: its ResnetBlocks' 512 -> 512
convs); halo_conv_reflect_tiled takes k in {3, 7} and stride 1 or 2 (on the
generators' paths: the 7x7 4 -> 64 stem). The kernels
(halo_conv_reflect_tiled: inside stem_conv.py's envelope, which holds the
7x7 stride-1 stem, the persistent stem conv of csrc/stem_conv.cu, see
stem_conv.py; every other shape lama_tpu_torch/csrc/halo_conv.cu;
halo_conv3x3_reflect: in bf16 the wgmma implicit GEMM of
csrc/conv3x3_wgmma.cu, see conv3x3_wgmma.py, in fp32 the register-tiled
SIMT implicit GEMM of csrc/conv3x3_simt.cu, see conv3x3_simt.py) stage
each output tile's input rows with their reflected halo rows and columns
in shared memory. The TPU envelopes are its VMEM and tiling limits, which
a Hopper kernel that tiles the image does not have (see each `_supported`):
here any C, C_out >= 1 and H, W > k // 2 (torch's reflect pad needs no
more). Inside, the layout is channels-last, as in reflect_conv.py: the
wrapper passes a channels-last view of `x`, an HWIO copy of the weight in
`x`'s dtype (the 3x3 conv: the packed weight of conv3x3_wgmma.py or
conv3x3_simt.py), and returns a channels-last output.
Types: float32 (fp32 FMA, no TF32) and bfloat16 (fp32 accumulation, bf16
output).

Each wrapper calls its registered op (library.py), which launches the
kernel on a CUDA tensor (or raises) and computes the plain version on a CPU
tensor; a CPU call that needs a gradient takes the plain version itself.
When a gradient is needed on the card the op runs inside
`_autograd.differentiable` (the plain version's VJP as its backward). The
op's CUDA implementation counts the launches in the wrapper's `launches`
attribute.
"""
import ctypes
import functools

import torch

from . import _build, conv3x3_simt, conv3x3_wgmma, stem_conv
from ._autograd import through_op
from .reflect_conv import reflect_conv_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SIZES, STRIDES = (3, 7), (1, 2)


def halo_conv_reflect_tiled_supported(h: int, w: int, c: int, c_out: int,
                                      k: int, s: int) -> bool:
    """k in {3, 7}, stride 1 or 2, and an input a reflect pad of k // 2 can
    take (H, W > k // 2); any channel counts. The TPU envelope's C % 8 == 0,
    W % 128 == 0 and H % (16 s) == 0 are its sublane and lane tiling, which
    this kernel does not need."""
    return (k in KERNEL_SIZES and s in STRIDES and c >= 1 and c_out >= 1
            and h > k // 2 and w > k // 2)


def halo_conv3x3_reflect_plain(x, weight, bias=None):
    """Plain version of halo_conv3x3_reflect: reflect pad by 1, then the
    3x3 conv, in `x`'s dtype."""
    return reflect_conv_plain(x, weight, bias)


def halo_conv3x3_reflect_supported(h: int, w: int, c: int, c_out: int) -> bool:
    """3x3 stride 1 (the wrapper's only form), any C, C_out >= 1, and
    H, W >= 2, which torch's reflect pad of 1 needs. The TPU kernel's
    envelope (halo_conv.py:29-32) is a VMEM budget, not a shape rule: one
    program holds a whole image, its padded copy and the fp32 accumulator
    in under 9 MB, which takes (32, 32, 512, 512) but not serving's
    (64, 64, 512, 512). The kernels tile the image (bf16: 256 output pixels
    x 128 output channels per block; fp32: 128 x 128; input channels a
    chunk at a time in shared memory), so their memory per block does not
    grow with the image and the budget is dropped."""
    return c >= 1 and c_out >= 1 and h >= 2 and w >= 2


def tiled_route(h: int, w: int, c: int, c_out: int, k: int, s: int):
    """The launch that takes a halo_conv_reflect_tiled call of this shape,
    in both dtypes: stem_conv.py's inside its envelope (the 7x7 stride-1
    stem), else None (halo_conv.cu's)."""
    return (stem_conv.stem_conv_reflect
            if stem_conv.supported(h, w, c, c_out, k, s) else None)


def _kernel6_supported(h, w, c, c_out, k, s):
    return k == 3 and s == 1 and halo_conv3x3_reflect_supported(h, w, c, c_out)


def _launch(name, supported, extra, stride, x, weight, bias, bf16=None,
            fp32=None):
    """Launch the route given for x's dtype (`bf16`: conv3x3_wgmma.py's or
    stem_conv.py's launch; `fp32`: conv3x3_simt.py's or stem_conv.py's), or
    else `lama_<name>` of halo_conv.cu: (x, w, bias, out, B, H, W, C, Co,
    *extra, dtype, stream)."""
    b, c, h, w = x.shape
    c_out, k = weight.shape[0], weight.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f'{name}: dtype {x.dtype} (expected float32 or '
                        'bfloat16)')
    if tuple(weight.shape) != (c_out, c, k, k):
        raise ValueError(f'{name}: weight {tuple(weight.shape)} for input '
                         f'{tuple(x.shape)}')
    if not supported(h, w, c, c_out, k, stride):
        raise ValueError(f'{name}: shape {(b, c, h, w)} -> {c_out}, k {k}, '
                         f'stride {stride} is outside the kernel envelope')
    if not (weight.is_cuda and (bias is None or bias.is_cuda)
            and weight.device == x.device):
        raise ValueError(f'{name}: weight and bias must be on {x.device}')
    x = x.contiguous(memory_format=torch.channels_last)
    route = bf16 if x.dtype == torch.bfloat16 else fp32
    if route is not None:
        return route(x, weight, bias)
    wk = weight.to(x.dtype).permute(2, 3, 1, 0).contiguous()   # HWIO
    bk = None if bias is None else bias.to(x.dtype).contiguous()
    out = torch.empty((b, c_out, (h - 1) // stride + 1, (w - 1) // stride + 1),
                      dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    fn = getattr(_build.load('halo_conv'), 'lama_' + name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * (6 + len(extra))
                   + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), wk.data_ptr(),
                 None if bk is None else bk.data_ptr(), out.data_ptr(),
                 b, h, w, c, c_out, *extra, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {err}')
    return out


def launch_3x3(x, weight, bias=None):
    """halo_conv3x3_reflect's kernel on CUDA tensors: the CUDA
    implementation of its registered op (library.py)."""
    return _launch('halo_conv3x3_reflect', _kernel6_supported, (), 1, x,
                   weight, bias, bf16=conv3x3_wgmma.conv3x3_reflect_bf16,
                   fp32=conv3x3_simt.conv3x3_reflect_fp32)


def launch_tiled(x, weight, bias=None, stride=1):
    """halo_conv_reflect_tiled's kernel on CUDA tensors (stem_conv.cu
    inside its envelope, else halo_conv.cu): the CUDA implementation of
    its registered op (library.py)."""
    k = weight.shape[-1]
    route = tiled_route(x.shape[2], x.shape[3], x.shape[1], weight.shape[0],
                        k, stride)
    return _launch('halo_conv_reflect_tiled',
                   halo_conv_reflect_tiled_supported, (k, stride), stride, x,
                   weight, bias, bf16=route, fp32=route)


def halo_conv3x3_reflect(x, weight, bias=None):
    """3x3 stride-1 reflect-'same' conv of any channel counts; on the
    GlobalGenerator's path: its ResnetBlocks' 512 -> 512 convs. bf16: the
    wgmma kernel of csrc/conv3x3_wgmma.cu; fp32: the stride-1 SIMT kernel
    of csrc/conv3x3_simt.cu."""
    return through_op(torch.ops.lama_tpu_torch.halo_conv3x3_reflect.default,
                      halo_conv3x3_reflect_plain, x, weight, bias)


def halo_conv_reflect_tiled(x, weight, bias=None, stride=1):
    """k x k reflect-'same' conv with `stride` (k in {3, 7}, stride 1 or 2);
    on the generators' path: the 7x7 4 -> 64 stem, which runs
    csrc/stem_conv.cu in both dtypes (`tiled_route`); every other shape
    runs csrc/halo_conv.cu."""
    return through_op(
        functools.partial(
            torch.ops.lama_tpu_torch.halo_conv_reflect_tiled.default,
            stride=stride),
        functools.partial(reflect_conv_plain, stride=stride), x, weight, bias)


halo_conv3x3_reflect.launches = 0
halo_conv_reflect_tiled.launches = 0
