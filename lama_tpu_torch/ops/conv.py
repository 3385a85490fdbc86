"""Convolutions with torch init and semantics, plus the kernel dispatch
(counterpart of lama_tpu/ops/conv.py).

`conv2d` sends a reflect-padded conv whose shape is in a kernel's envelope
to that kernel (ops/kernels/reflect_conv.py, ops/kernels/halo_conv.py):
  3x3 s1, C = C_out = 128                          -> reflect_conv3x3_cols
  3x3 s1, C != C_out, both multiples of 128        -> reflect_conv3x3_taps
  every other 3x3 s1, H, W >= 2                    -> halo_conv3x3_reflect
  3x3 s2, 2C and C_out multiples of 128, H, W even -> reflect_down_conv3x3
  7x7 s1, C_out <= 8, C <= 128, C % 8 == 0         -> reflect_out_conv7x7
  other 7x7 (s1, s2) and 3x3 s2, H, W > k // 2     -> halo_conv_reflect_tiled
The 3x3 stride-1 order is the JAX conv2d's (conv.py:258-281: cols, then the
halo conv), with taps kept on the FFC's l2g (128 -> 384) and g2l (384 ->
128) convs it was written for (reflect_conv.py:427); the JAX dispatch never
routes to taps. So every reflect conv of both generator families runs on a
kernel: big-lama's on kernels 1-5 and 7 (the 7x7 4->64 stem on the tiled
halo conv), the GlobalGenerator's ResnetBlock convs (512 -> 512) on the 3x3
halo conv. Its zero-padded stride-2 downsamples, the ConvTranspose layers
and the 1x1 convs are `F.conv2d` (after `F.pad` for other pad modes), as the
JAX package leaves them to XLA (conv.py:285-301).
In bf16 the four 3x3 kernels (cols, taps, halo 3x3, and down at stride 2)
are one wgmma implicit GEMM, ops/kernels/conv3x3_wgmma.py; in fp32 they are
one register-tiled SIMT implicit GEMM (stride 1 and 2, K split where a
stride-1 grid fills less than one wave), ops/kernels/conv3x3_simt.py. The
7x7 head is reflect_conv.cu's only kernel.
`kernels='plain'` sends the kernels' shapes to their plain version too; it
is how the tests and chip_smoke.py compare the two.

int8 serving (counterpart of lama_tpu/ops/conv.py:430-443 and :483-491):
a Conv2d or ConvTranspose2d built with a `mode` whose int8 is on, and
eligible by ops/quant.py::conv_eligible, runs the int8 conv
(ops/kernels/conv_int8.py: the kernel on a CUDA tensor, the plain version
on a CPU tensor or under kernels='plain'). The FourierUnit's spectral conv
never quantizes: it is a plain nn.Conv2d, not this module. Its activation scale is dynamic
unless its non-persistent `act_amax` buffer holds a calibrated max |x|
(serving.py::calibrate_int8, lama_tpu's 'quant_stats' collection; out of
the state_dict, so a reference checkpoint still loads strictly). Its
packed int8 weight is kept per set of weights; while exporting, the
weight has no storage to key that cache on, and the module reads the
packed weight that `freeze_for_export` stored in its buffers instead.
"""
import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import quant
from .kernels import conv_int8
from .kernels import halo_conv as hc
from .kernels import reflect_conv as rc
from .kernels.library import exporting, frozen
from .pad import pad2d
from .serving_mode import DEFAULT as DEFAULT_MODE

KERNEL_CHOICES = ('cuda', 'plain')


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def check_kernels(kernels: str) -> str:
    if kernels not in KERNEL_CHOICES:
        raise ValueError(f'kernels={kernels!r}: expected one of '
                         f'{KERNEL_CHOICES}')
    return kernels


def kernel_for(x, weight, stride, padding, dilation, groups, padding_mode):
    """The kernel wrapper (ops/kernels/reflect_conv.py or halo_conv.py,
    the tiled halo conv with its stride bound) that takes this conv, or None
    when it goes to the stock conv."""
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    kh, kw = weight.shape[-2:]
    shape = (x.shape[2], x.shape[3], x.shape[1], weight.shape[0])
    if not (padding_mode == 'reflect' and groups == 1
            and stride in ((1, 1), (2, 2)) and dilation == (1, 1) and kh == kw
            and padding == (kh // 2, kw // 2)
            and x.dtype in (torch.float32, torch.bfloat16)):
        return None
    if stride == (2, 2):
        if kh == 3 and rc.reflect_down_conv3x3_supported(*shape):
            return rc.reflect_down_conv3x3
    elif kh == 3:
        if rc.reflect_conv3x3_cols_supported(*shape):
            return rc.reflect_conv3x3_cols
        if shape[2] != shape[3] and rc.reflect_conv3x3_taps_supported(*shape):
            return rc.reflect_conv3x3_taps
        if hc.halo_conv3x3_reflect_supported(*shape):
            return hc.halo_conv3x3_reflect
        return None
    elif kh == 7 and rc.reflect_out_conv7x7_supported(*shape):
        return rc.reflect_out_conv7x7
    if hc.halo_conv_reflect_tiled_supported(*shape, kh, stride[0]):
        return functools.partial(hc.halo_conv_reflect_tiled, stride=stride[0])
    return None


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           padding_mode='zeros', kernels='cuda'):
    """NCHW input, OIHW weight, torch semantics; computes in x's dtype."""
    kernel = (kernel_for(x, weight, stride, padding, dilation, groups,
                         padding_mode) if kernels == 'cuda' else None)
    if kernel is not None:
        return kernel(x, weight, bias)
    padding = _pair(padding)
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if padding_mode != 'zeros' and padding != (0, 0):
        # the pad returns NCHW whatever its input's layout. A dilated reflect
        # conv (a multidilated branch) is summed with a kernel's
        # channels-last output: its padded channels-last input (channel
        # stride 1, as the generators hand over, or a channel slice of one)
        # is made channels-last again, so cuDNN returns channels-last and the
        # sum takes no strided pass (ablv2_work_md, bf16, b16 at 512^2 on an
        # H100: 51.3 -> 39.6 device ms a forward, PERF.md). The undilated
        # stock convs keep NCHW: with the extra copy big-lama's plain bf16
        # forward ran 125 img/s where it runs 156.
        channels_last = (_pair(dilation) != (1, 1) and x.stride(1) == 1
                         and x.shape[1] > 1)
        x = pad2d(x, padding, mode=padding_mode)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        padding = (0, 0)
    return F.conv2d(x, weight, bias, stride, padding, dilation, groups)


class _Quantized:
    """The int8 serving state of a conv module: its mode, whether it
    quantizes, the calibrated act_amax buffer and the packed weight."""

    def _init_quant(self, mode, groups):
        self.mode = mode
        self.quantized = bool(
            mode.int8 and quant.conv_eligible(
                self.in_channels, self.out_channels, groups,
                *self.kernel_size, mode))
        self.register_buffer('act_amax', None, persistent=False)
        self._packed_key = None
        self._packed = None
        # the packed weight a program exported from this module reads as
        # constants (`freeze_for_export`)
        self.register_buffer('export_packed_codes', None, persistent=False)
        self.register_buffer('export_packed_scales', None, persistent=False)

    def _act_amax(self, x):
        """The static amax, or None for a dynamic scale. Calibrating, this
        call's max |x| joins the buffer's max (lama_tpu's sow with
        reduce_fn=max, ops/conv.py:367-384) and the call serves with a
        dynamic scale."""
        if self.mode.calibrating:
            amax = x.detach().float().abs().amax()
            self.act_amax = (amax if self.act_amax is None
                             else torch.maximum(self.act_amax, amax))
            return None
        return self.act_amax

    def _pack(self):
        """pack_weight's result, recomputed only when the weight changed
        (its storage or, for a tensor with a version, its version), as
        FourierUnit.planar keys its cache; None under kernels='plain'.
        Exporting, the weight has no storage: the export buffers."""
        if self.kernels == 'plain':
            return None
        if exporting():
            return frozen(self, 'export_packed_codes', 'export_packed_scales')
        w = self.weight
        key = (w.data_ptr(), -1 if w.is_inference() else w._version)
        if key != self._packed_key:
            self._packed = conv_int8.pack_weight(w, self.transposed)
            self._packed_key = key
        return self._packed

    def freeze_for_export(self):
        """Fill the export buffers with the packed weight of the current
        weights, so a program exported after this call reads them as
        constants instead of quantizing the weight at every call."""
        if self.quantized and self.kernels != 'plain':
            self.export_packed_codes, self.export_packed_scales = (
                self._pack())


class Conv2d(_Quantized, nn.Conv2d):
    """nn.Conv2d (reference keys and init) whose forward runs `conv2d` in
    the input's dtype, so the parameters stay float32 under bf16 compute;
    or the int8 conv, when `mode` serves int8 and the conv is eligible."""

    def __init__(self, *args, kernels: str = 'cuda', mode=DEFAULT_MODE,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.kernels = check_kernels(kernels)
        self._init_quant(mode, self.groups)

    def forward(self, x):
        if self.quantized:
            return conv_int8.quantized_conv2d(
                x, self.weight, self.bias, self.stride, self.padding,
                self.dilation, self.groups, self.padding_mode,
                act_amax=self._act_amax(x), zero_pad=self.mode.zero_pad,
                packed=self._pack(), kernels=self.kernels)
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups, self.padding_mode,
                      self.kernels)


class ConvTranspose2d(_Quantized, nn.ConvTranspose2d):
    """nn.ConvTranspose2d (weight (I, O, kh, kw), as the reference) run in
    the input's dtype; or the int8 conv, as Conv2d."""

    def __init__(self, *args, kernels: str = 'cuda', mode=DEFAULT_MODE,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.kernels = check_kernels(kernels)
        self._init_quant(mode, 1)

    def forward(self, x):
        if self.quantized:
            return conv_int8.quantized_conv_transpose2d(
                x, self.weight, self.bias, self.stride, self.padding,
                self.output_padding, act_amax=self._act_amax(x),
                packed=self._pack(), kernels=self.kernels)
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)
