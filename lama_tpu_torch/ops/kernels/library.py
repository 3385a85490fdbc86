"""The port's kernels as registered operators, namespace `lama_tpu_torch`.

Every kernel wrapper of this package calls one of these ops, so an eager
forward and a program exported with `torch.export` (lama_tpu_torch/
export.py) take the same path: the exported graph holds a
`torch.ops.lama_tpu_torch.<name>` call where eager mode launches a kernel.
Importing this module registers them all; it is all that a process which
loads an exported program (`torch.export.load`) needs of the port:

    import torch
    import lama_tpu_torch.ops.kernels.library  # noqa: F401
    program = torch.export.load('inpainter_512x512.pt2').module()

One op per launch entry:

  reflect_conv3x3_cols, reflect_conv3x3_taps,   reflect_conv.py (kernels 2-5:
  reflect_down_conv3x3, reflect_out_conv7x7     conv3x3_wgmma.cu, conv3x3_simt.cu,
                                                reflect_conv.cu)
  halo_conv3x3_reflect, halo_conv_reflect_tiled halo_conv.py (kernels 6-7:
                                                the same 3x3 sources,
                                                stem_conv.cu, halo_conv.cu)
  fused_fourier_unit                            fourier_unit.py (kernel 1,
                                                fourier_unit.cu)
  int8_amax_quantize, int8_quantize,            conv_int8.py (the amax and
  int8_conv                                     quantize passes, the
                                                quantize pass on a
                                                calibrated amax, the GEMM;
                                                conv_int8.cu)

Each op is defined with torch.library.Library (define, impl) and
`register_fake`: a call dispatches straight to its implementation, with
none of the Python layers of torch.library.custom_op around it, host time
that each of a big-lama forward's ~150 kernel calls would pay
(tools/op_dispatch_time.py times both registrations). It has no
autograd kernel: the wrappers call it inside _autograd.differentiable,
whose backward is the plain version's VJP. Each op has three
implementations:
  CUDA: the hand-written kernel, launched as the wrapper launched it
    before (ctypes, PyTorch's current stream); it counts its launch in its
    wrapper's `launches` attribute (the int8 GEMM in quantized_conv2d's),
    so the calls of a loaded exported program count too. A build or launch
    error raises; nothing falls back to the plain version.
  CPU: the plain version, laid out as the kernel lays out its output.
  fake (`register_fake`): the CUDA implementation's shape, dtype and
    strides: channels-last for every conv and the FourierUnit, (B, H, W,
    Cp) contiguous int8 codes (and a (1,) float32 amax for the amax op).
The packed weights are op inputs: the FourierUnit's folded (W, bias) and
the int8 conv's packed codes and scales. In eager mode the modules keep
them cached (models/ffc.py FourierUnit.planar, ops/conv.py _Quantized).
While exporting (`exporting()`) the parameters have no storage to key a
cache on: the modules then read the buffers that `freeze_for_export`
filled from the current weights (export.py calls it on every module), so
the program holds them as constants. A calibrated int8 `act_amax` is a
buffer too, so it
lands in the program as one and the quantize and GEMM ops read it as it
stands. The other per-call weight
relayouts (pack_conv3x3_weight and the head's and stem's pack_weight) run
inside the CUDA implementations, as they did before.
"""
import torch

from . import conv_int8, fourier_unit, halo_conv, reflect_conv

NAMESPACE = 'lama_tpu_torch'
CONV_SCHEMA = '(Tensor x, Tensor weight, Tensor? bias) -> Tensor'


def exporting() -> bool:
    """Whether the caller runs under torch.export (or torch.compile), where
    parameters are fake tensors without storage: the modules then read
    their packed weights from the buffers `freeze_for_export` filled
    (`frozen`) instead of their storage-keyed caches."""
    return torch.compiler.is_compiling()


def frozen(module, *names):
    """The export buffers `names` of `module` (the packed weights that its
    `freeze_for_export` fills), as an exported program reads them; raises
    when they were not filled."""
    buffers = tuple(getattr(module, n) for n in names)
    if any(b is None for b in buffers):
        raise RuntimeError(
            f'{type(module).__name__}: call freeze_for_export() on every '
            'module before torch.export (export.export_inpainter does)')
    return buffers


def _channels_last(t):
    """t copied into fresh channels-last strides: the layout the kernels'
    outputs have (torch.empty(..., memory_format=channels_last)), also
    where t's size-1 dims would let .contiguous() keep other strides."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device,
                       memory_format=torch.channels_last).copy_(t)


def _empty_channels_last(shape, like, dtype=None):
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device,
                       memory_format=torch.channels_last)


LIB = torch.library.Library(NAMESPACE, 'DEF')


def _define(name, schema, cuda, cpu, fake):
    """Op `lama_tpu_torch::<name>(schema)`: `cuda` on CUDA tensors, `cpu`
    on CPU ones, `fake` for fake and meta tensors; no other device has an
    implementation, so a call there raises."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, 'CUDA')
    LIB.impl(name, cpu, 'CPU')
    torch.library.register_fake(f'{NAMESPACE}::{name}', fake, lib=LIB)
    return getattr(torch.ops.lama_tpu_torch, name).default


def _counted(wrapper, launch):
    """launch(...), then one more launch on the wrapper's count."""
    def impl(*args, **kwargs):
        out = launch(*args, **kwargs)
        wrapper.launches += 1
        return out
    return impl


def _out_hw(h, w, k, stride):
    return (h - 1) // stride + 1, (w - 1) // stride + 1


# ---- the reflect convs (reflect_conv.py, halo_conv.py)
def _conv_fake(stride):
    def fake(x, weight, bias=None):
        ho, wo = _out_hw(x.shape[2], x.shape[3], weight.shape[-1], stride)
        return _empty_channels_last((x.shape[0], weight.shape[0], ho, wo), x)
    return fake


def _conv_cpu(stride):
    def cpu(x, weight, bias=None):
        return _channels_last(reflect_conv.reflect_conv_plain(x, weight, bias,
                                                              stride))
    return cpu


def _reflect_cuda(name):
    def cuda(x, weight, bias=None):
        return reflect_conv.launch(name, x, weight, bias)
    return _counted(getattr(reflect_conv, name), cuda)


OPS = {}
for _name, (_, _stride, _, _) in reflect_conv.ROUTES.items():
    OPS[_name] = _define(_name, CONV_SCHEMA, _reflect_cuda(_name),
                         _conv_cpu(_stride), _conv_fake(_stride))

OPS['halo_conv3x3_reflect'] = _define(
    'halo_conv3x3_reflect', CONV_SCHEMA,
    _counted(halo_conv.halo_conv3x3_reflect,
             lambda x, w, b=None: halo_conv.launch_3x3(x, w, b)),
    _conv_cpu(1), _conv_fake(1))


def _tiled_fake(x, weight, bias=None, stride=1):
    return _conv_fake(stride)(x, weight, bias)


def _tiled_cpu(x, weight, bias=None, stride=1):
    return _conv_cpu(stride)(x, weight, bias)


OPS['halo_conv_reflect_tiled'] = _define(
    'halo_conv_reflect_tiled',
    '(Tensor x, Tensor weight, Tensor? bias, int stride) -> Tensor',
    _counted(halo_conv.halo_conv_reflect_tiled,
             lambda x, w, b, s: halo_conv.launch_tiled(x, w, b, s)),
    _tiled_cpu, _tiled_fake)


# ---- kernel 1, the eval FourierUnit (fourier_unit.py)
def _fu_fake(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var, wp, bp,
             eps, store_bf16, norm='ortho'):
    return _empty_channels_last(
        (x.shape[0], conv_weight.shape[0] // 2, x.shape[2], x.shape[3]), x,
        torch.bfloat16 if store_bf16 else torch.float32)


def _fu_cpu(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var, wp, bp,
            eps, store_bf16, norm='ortho'):
    return _channels_last(fourier_unit.fourier_unit_plain(
        x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var, eps, store_bf16,
        norm))


def _fu_cuda(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var, wp, bp,
             eps, store_bf16, norm='ortho'):
    return fourier_unit._launch(x, conv_weight, bn_weight, bn_bias, bn_mean,
                                bn_var, eps, (wp, bp), store_bf16, norm)


OPS['fused_fourier_unit'] = _define(
    'fused_fourier_unit',
    '(Tensor x, Tensor conv_weight, Tensor bn_weight, Tensor bn_bias, '
    'Tensor bn_mean, Tensor bn_var, Tensor wp, Tensor bp, float eps, '
    'bool store_bf16, str norm="ortho") -> Tensor',
    _counted(fourier_unit.fused_fourier_unit, _fu_cuda), _fu_cpu, _fu_fake)


# ---- the int8 conv (conv_int8.py)
def _codes_fake(x):
    b, c, h, w = x.shape
    return x.new_empty((b, h, w, conv_int8.round_up(c, conv_int8.CHUNK)),
                       dtype=torch.int8)


OPS['int8_amax_quantize'] = _define(
    'int8_amax_quantize', '(Tensor x) -> (Tensor, Tensor)',
    conv_int8.quantize_activation, conv_int8.quantize_activation_plain,
    lambda x: (_codes_fake(x), x.new_empty((1,), dtype=torch.float32)))


def _quantize_cpu(x, amax):
    return conv_int8.quantize_activation_plain(x, amax)[0]


OPS['int8_quantize'] = _define(
    'int8_quantize', '(Tensor x, Tensor amax) -> Tensor',
    conv_int8.quantize_codes, _quantize_cpu, lambda x, amax: _codes_fake(x))

INT8_CONV_SCHEMA = (
    '(Tensor codes, Tensor amax, Tensor packed, Tensor s_w, Tensor? bias, '
    'int c, int co, int kh, int kw, int[] stride, int[] padding, '
    'int[] dilation, int[] output_padding, str padding_mode, bool zero_pad, '
    'bool transposed, ScalarType out_dtype) -> Tensor')


def _int8_plan(codes, c, co, kh, kw, stride, padding, dilation,
               output_padding, padding_mode, zero_pad, transposed,
               cached=True):
    """The int8 conv's plan from the op's arguments: the cached plan that
    the wrapper's check made (the int[] arguments as tuples, as it has
    them); uncached for a fake tensor, whose sizes may be symbolic."""
    b, h, w, _ = codes.shape
    if transposed:
        plan = conv_int8.conv_transpose_plan
        args = ((b, c, h, w), (c, co, kh, kw), tuple(stride), tuple(padding),
                tuple(output_padding))
    else:
        plan = conv_int8.conv_plan
        args = ((b, c, h, w), (co, c, kh, kw), tuple(stride), tuple(padding),
                tuple(dilation), 1, padding_mode, zero_pad)
    return plan(*args) if cached else plan.__wrapped__(*args)


def _int8_conv_fake(codes, amax, packed, s_w, bias, c, co, kh, kw, stride,
                    padding, dilation, output_padding, padding_mode, zero_pad,
                    transposed, out_dtype):
    plan = _int8_plan(codes, c, co, kh, kw, stride, padding, dilation,
                      output_padding, padding_mode, zero_pad, transposed,
                      cached=False)
    return _empty_channels_last((codes.shape[0], co, plan.ho, plan.wo),
                                codes, out_dtype)


def _int8_conv_cuda(codes, amax, packed, s_w, bias, c, co, kh, kw, stride,
                    padding, dilation, output_padding, padding_mode, zero_pad,
                    transposed, out_dtype):
    plan = _int8_plan(codes, c, co, kh, kw, stride, padding, dilation,
                      output_padding, padding_mode, zero_pad, transposed)
    return conv_int8.conv_codes(codes, amax, packed, s_w, bias, plan, co,
                                out_dtype)


OPS['int8_conv'] = _define(
    'int8_conv', INT8_CONV_SCHEMA,
    _counted(conv_int8.quantized_conv2d, _int8_conv_cuda),
    conv_int8.conv_codes_plain, _int8_conv_fake)


__all__ = ['LIB', 'NAMESPACE', 'OPS', 'exporting', 'frozen']
