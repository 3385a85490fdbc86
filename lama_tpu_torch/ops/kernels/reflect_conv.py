"""Reflect-padded convolutions: CUDA kernels and their plain versions.

Counterparts of the TPU kernels in lama_tpu/ops/pallas/reflect_conv.py:

  reflect_conv3x3_cols   <- reflect_conv3x3_cols  (reflect_conv.py:130)
  reflect_conv3x3_taps   <- reflect_conv3x3_taps  (reflect_conv.py:465)
  reflect_down_conv3x3   <- reflect_down_conv3x3  (reflect_conv.py:230)
  reflect_out_conv7x7    <- reflect_out_conv7x7   (reflect_conv.py:327)

Each computes `F.conv2d(F.pad(x, (p,)*4, mode='reflect'), weight, bias,
stride)` with p = k // 2 on NCHW tensors (any memory format) and an OIHW
weight, and keeps the TPU kernel's envelope; the down conv has stride 2, the
others stride 1. The kernels build the reflect halo while loading an input
tile into shared memory, so no padded tensor reaches HBM:
  float32 (full fp32 arithmetic, no TF32): the three 3x3 convs run the
    register-tiled SIMT implicit GEMM of lama_tpu_torch/csrc/conv3x3_simt.cu
    (see conv3x3_simt.py; cols and taps its stride-1 form, with K split
    over several blocks where the grid fills less than one wave, the down
    conv its stride-2 form);
  bfloat16 (tensor cores, fp32 accumulation, bf16 output): the three 3x3
    convs run the wgmma implicit GEMM of csrc/conv3x3_wgmma.cu (see
    conv3x3_wgmma.py; the down conv its stride-2 width-pair form);
  the 7x7 head, in either dtype, the persistent kernel of
    lama_tpu_torch/csrc/reflect_conv.cu (see head_conv.py; bf16 on
    mma.sync with the kx taps and output channels in N, fp32 a 2-D
    register-tiled FFMA conv).
Inside, the layout is channels-last: the wrapper passes a channels-last
view of `x` (a copy only if `x` is not channels-last already), the packed
weight of conv3x3_wgmma.py, conv3x3_simt.py or head_conv.py, and returns
a channels-last output.

Each wrapper calls its registered op, `lama_tpu_torch::<wrapper name>`
(library.py), which launches the kernel on a CUDA tensor (or raises) and
computes the plain version on a CPU tensor; a CPU call that needs a
gradient takes the plain version itself. When a gradient is needed on the
card, the op runs inside `_autograd.differentiable`: the forward is the
kernel, the backward the VJP of the plain version recomputed on the saved
inputs, as the TPU kernels' `_diff_wrap` (reflect_conv.py:59-87) takes the
XLA VJP. Neither has a backward kernel. The op's CUDA implementation counts
the launches in the wrapper's `launches` attribute, so a loaded exported
program's calls count too.
"""
import functools

import torch
import torch.nn.functional as F

from . import conv3x3_simt, conv3x3_wgmma, head_conv
from ._autograd import through_op

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reflect_conv_plain(x, weight, bias=None, stride=1):
    """Plain version of every kernel here: reflect pad by k // 2, then a
    conv with `stride` in `x`'s dtype."""
    p = weight.shape[-1] // 2
    return F.conv2d(F.pad(x, (p, p, p, p), mode='reflect'),
                    weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype), stride)


reflect_down_conv3x3_plain = functools.partial(reflect_conv_plain, stride=2)


def reflect_conv3x3_cols_supported(h: int, w: int, c: int, c_out: int) -> bool:
    """The TPU kernel's envelope (reflect_conv.py:94): C = C_out = 128."""
    return c == 128 and c_out == 128 and h >= 8 and w >= 8


def reflect_conv3x3_taps_supported(h: int, w: int, c: int, c_out: int) -> bool:
    """The TPU kernel's envelope (reflect_conv.py:436): C and C_out multiples
    of 128, other than 128/128 (which is cols')."""
    return (c % 128 == 0 and c_out % 128 == 0 and (c, c_out) != (128, 128)
            and h >= 8 and w >= 8)


def reflect_down_conv3x3_supported(h: int, w: int, c: int, c_out: int) -> bool:
    """The TPU kernel's envelope (reflect_conv.py:176) without its row-tile
    divisibility and VMEM budget, which this kernel does not need: 2C and
    C_out multiples of 128, H and W even and at least 8."""
    return ((2 * c) % 128 == 0 and c_out % 128 == 0 and h % 2 == 0
            and w % 2 == 0 and h >= 8 and w >= 8)


def reflect_out_conv7x7_supported(h: int, w: int, c: int, c_out: int) -> bool:
    """The TPU kernel's envelope (reflect_conv.py:291) without its row-tile
    divisibility, which this kernel does not need: C_out <= 8, C <= 128,
    C % 8 == 0."""
    return 1 <= c_out <= 8 and c <= 128 and c % 8 == 0 and h >= 8 and w >= 8


def _launch(name, supported, x, weight, bias, bf16=None, fp32=None):
    """Check the call, then launch the route given for x's dtype (`bf16`,
    `fp32`: a launch function of x, weight and bias); a dtype with no route
    raises."""
    ksize = weight.shape[-1]
    b, c, h, w = x.shape
    c_out = weight.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f'{name}: dtype {x.dtype} (expected float32 or '
                        'bfloat16)')
    if tuple(weight.shape) != (c_out, c, ksize, ksize):
        raise ValueError(f'{name}: weight {tuple(weight.shape)} for input '
                         f'{tuple(x.shape)}')
    if not supported(h, w, c, c_out):
        raise ValueError(f'{name}: shape {(b, c, h, w)} -> {c_out} is '
                         'outside the kernel envelope')
    if not (weight.is_cuda and (bias is None or bias.is_cuda)
            and weight.device == x.device):
        raise ValueError(f'{name}: weight and bias must be on {x.device}')
    route = bf16 if x.dtype == torch.bfloat16 else fp32
    if route is None:
        raise TypeError(f'{name}: no kernel for {x.dtype}')
    return route(x.contiguous(memory_format=torch.channels_last), weight,
                 bias)


# each wrapper's launch: its envelope, stride and the route of each dtype
ROUTES = {
    'reflect_conv3x3_cols': (reflect_conv3x3_cols_supported, 1,
                             conv3x3_wgmma.conv3x3_reflect_bf16,
                             conv3x3_simt.conv3x3_reflect_fp32),
    'reflect_conv3x3_taps': (reflect_conv3x3_taps_supported, 1,
                             conv3x3_wgmma.conv3x3_reflect_bf16,
                             conv3x3_simt.conv3x3_reflect_fp32),
    'reflect_down_conv3x3': (
        reflect_down_conv3x3_supported, 2,
        functools.partial(conv3x3_wgmma.conv3x3_reflect_bf16, stride=2),
        functools.partial(conv3x3_simt.conv3x3_reflect_fp32, stride=2)),
    'reflect_out_conv7x7': (reflect_out_conv7x7_supported, 1,
                            head_conv.head_conv_reflect,
                            head_conv.head_conv_reflect),
}


def launch(name, x, weight, bias=None):
    """The kernel of wrapper `name` on CUDA tensors: the CUDA implementation
    of its registered op (library.py)."""
    supported, _, bf16, fp32 = ROUTES[name]
    return _launch(name, supported, x, weight, bias, bf16=bf16, fp32=fp32)


def _call(name, x, weight, bias):
    """The body of every wrapper below: the registered op
    `lama_tpu_torch::<name>` (the kernel on a CUDA tensor, the plain
    version on a CPU one), which counts the launches."""
    plain = functools.partial(reflect_conv_plain, stride=ROUTES[name][1])
    return through_op(getattr(torch.ops.lama_tpu_torch, name).default,
                      plain, x, weight, bias)


def reflect_conv3x3_cols(x, weight, bias=None):
    """3x3 stride-1 reflect conv for C = C_out = 128 (the FFC l2l convs).
    bf16: the wgmma kernel of csrc/conv3x3_wgmma.cu; fp32: the stride-1
    SIMT kernel of csrc/conv3x3_simt.cu."""
    return _call('reflect_conv3x3_cols', x, weight, bias)


def reflect_conv3x3_taps(x, weight, bias=None):
    """3x3 stride-1 reflect conv for wide channels (the FFC l2g/g2l convs).
    bf16: the wgmma kernel of csrc/conv3x3_wgmma.cu; fp32: the stride-1
    SIMT kernel of csrc/conv3x3_simt.cu."""
    return _call('reflect_conv3x3_taps', x, weight, bias)


def reflect_down_conv3x3(x, weight, bias=None):
    """3x3 stride-2 reflect conv (the generator's downsamples). bf16: the
    stride-2 wgmma kernel of csrc/conv3x3_wgmma.cu; fp32: the stride-2 SIMT
    kernel of csrc/conv3x3_simt.cu."""
    return _call('reflect_down_conv3x3', x, weight, bias)


def reflect_out_conv7x7(x, weight, bias=None):
    """7x7 stride-1 reflect conv with at most 8 output channels (the head),
    in either dtype the kernel of csrc/reflect_conv.cu (see head_conv.py):
    bf16 on mma.sync, fp32 a register-tiled FFMA conv."""
    return _call('reflect_out_conv7x7', x, weight, bias)


reflect_conv3x3_cols.launches = 0
reflect_conv3x3_taps.launches = 0
reflect_down_conv3x3.launches = 0
reflect_out_conv7x7.launches = 0
