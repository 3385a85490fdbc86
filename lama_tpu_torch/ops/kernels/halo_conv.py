"""Row-tiled reflect conv with the halo built on chip: CUDA kernel and its
plain version.

Counterpart of the TPU kernel lama_tpu/ops/pallas/halo_conv.py::
halo_conv_reflect_tiled (halo_conv.py:158): `F.conv2d(F.pad(x, (p,)*4,
mode='reflect'), weight, bias, stride)` with p = k // 2, for k in {3, 7} and
stride 1 or 2, on NCHW tensors (any memory format) and an OIHW weight. The
kernel (lama_tpu_torch/csrc/halo_conv.cu) stages each output row tile's input
rows with their reflected halo rows and columns in shared memory. The TPU
envelope's C % 8 == 0, W % 128 == 0 and H % (16 s) == 0 are its sublane and
lane tiling, which a Hopper kernel does not need: here any C, C_out >= 1 and
H, W > k // 2 (torch's reflect pad needs no more). Inside, the layout is
channels-last, as in reflect_conv.py: the wrapper passes a channels-last view
of `x`, an HWIO copy of the weight in `x`'s dtype, and returns a channels-last
output. Types: float32 (fp32 FMA, no TF32) and bfloat16 (fp32 accumulation,
bf16 output).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. When a gradient is needed the launch runs
inside `_autograd.differentiable` (the plain version's VJP as its backward).
The wrapper counts its launches in its `launches` attribute.
"""
import ctypes
import functools

import torch

from . import _build
from ._autograd import differentiable
from .reflect_conv import reflect_conv_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SIZES, STRIDES = (3, 7), (1, 2)


def halo_conv_reflect_tiled_supported(h: int, w: int, c: int, c_out: int,
                                      k: int, s: int) -> bool:
    """k in {3, 7}, stride 1 or 2, and an input a reflect pad of k // 2 can
    take (H, W > k // 2); any channel counts."""
    return (k in KERNEL_SIZES and s in STRIDES and c >= 1 and c_out >= 1
            and h > k // 2 and w > k // 2)


def _launch(stride, x, weight, bias):
    b, c, h, w = x.shape
    c_out, k = weight.shape[0], weight.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f'halo_conv_reflect_tiled: dtype {x.dtype} (expected '
                        'float32 or bfloat16)')
    if tuple(weight.shape) != (c_out, c, k, k):
        raise ValueError(f'halo_conv_reflect_tiled: weight '
                         f'{tuple(weight.shape)} for input {tuple(x.shape)}')
    if not halo_conv_reflect_tiled_supported(h, w, c, c_out, k, stride):
        raise ValueError(f'halo_conv_reflect_tiled: shape {(b, c, h, w)} -> '
                         f'{c_out}, k {k}, stride {stride} is outside the '
                         'kernel envelope')
    if not (weight.is_cuda and (bias is None or bias.is_cuda)
            and weight.device == x.device):
        raise ValueError('halo_conv_reflect_tiled: weight and bias must be on '
                         f'{x.device}')
    x = x.contiguous(memory_format=torch.channels_last)
    wk = weight.to(x.dtype).permute(2, 3, 1, 0).contiguous()   # HWIO
    bk = None if bias is None else bias.to(x.dtype).contiguous()
    out = torch.empty((b, c_out, (h - 1) // stride + 1, (w - 1) // stride + 1),
                      dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    fn = _build.load('halo_conv').lama_halo_conv_reflect_tiled
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), wk.data_ptr(),
                 None if bk is None else bk.data_ptr(), out.data_ptr(),
                 b, h, w, c, c_out, k, stride, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError('halo_conv_reflect_tiled: CUDA launch failed with '
                           f'error {err}')
    return out


def halo_conv_reflect_tiled(x, weight, bias=None, stride=1):
    """k x k reflect-'same' conv with `stride` (k in {3, 7}, stride 1 or 2);
    on the generator's path: the 7x7 4 -> 64 stem."""
    plain = functools.partial(reflect_conv_plain, stride=stride)
    if not x.is_cuda:
        return plain(x, weight, bias)
    out = differentiable(functools.partial(_launch, stride), plain,
                         x, weight, bias)
    halo_conv_reflect_tiled.launches += 1
    return out


halo_conv_reflect_tiled.launches = 0
