"""The FFC generator big-lama uses and the FFC PatchGAN discriminator, as
PyTorch modules over NCHW tensors.

Counterpart of lama_tpu/models/ffc.py (SELayer :88, FFCSE_block :106,
FourierUnit :136, SpectralTransform :333, FFC :377, FFC_BN_ACT :480,
LearnableSpatialTransformWrapper :521, FFCResnetBlock :557, concat_tuple
:606, FFCResNetGenerator :618, FFCNLayerDiscriminator :764); the
generator's stages 'full', 'front' and 'rear', in eval mode
and in train mode (batch-statistics BN; the FourierUnit takes its plain
path there, as the JAX package runs its fused kernel only outside
training, ffc.py:196). The
module tree mirrors the reference key-space (`model.N.*`, e.g.
`model.5.conv1.ffc.convg2g.conv1.0.weight`), so a reference-format state_dict
loads with `load_state_dict(strict=True)`.

The two streams are (local, global) tuples; an absent stream is None. Every
parameter stays float32; the generator casts its input to `dtype` (float32
or bfloat16) and each conv runs in its input's dtype, while BatchNorm and the
spectral path compute in float32, as in the JAX package. Modules are built
with `kernels='cuda'` (the hand-written kernels run on CUDA tensors; on CPU
tensors their plain versions run) or `kernels='plain'` (plain versions
everywhere). The generator's `mode` (ops/serving_mode.py) reaches every
conv and FourierUnit of the tree: under int8 the eligible convs quantize
(the l2l, l2g and g2l convs, the SpectralTransform's two 1x1 convs, the
downsamples and the ConvTranspose layers; lama_tpu/models/ffc.py:349-373),
the FourierUnit's spectral conv never does (:300-306), and
spectral_bf16_store reaches the FourierUnit. The SpectralTransform's LFU
(`enable_lfu`) is a second FourierUnit on the kernel path as the first;
the FFCResnetBlock's `inline` form is the pix2pixHD generators'
`ffc_positions` block. Every option of lama_tpu's FFC stack is here: the
FourierUnit's fft_norm, spatial scaling, positional encoding, SE, groups
and ffc3d; grouped and gated FFCs; FFCSE_block; the learnable spatial
transform (the generator's spatial_transform_layers); and the generator's
out_ffc block. lama_tpu's FFCResnetBlock also takes
spatial_transform_kwargs, which none of its generators passes; the port's
does not.
"""
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.activations import get_activation
from ..ops.conv import Conv2d, ConvTranspose2d, check_kernels
from ..ops.geometry import rotate
from ..ops.pad import pad2d
from ..ops.resize import interpolate
from ..ops.serving_mode import DEFAULT as DEFAULT_MODE
from ..ops.kernels.fourier_unit import (check_norm, fourier_unit_fft,
                                        fourier_unit_plain,
                                        fused_fourier_unit, kernel_fits,
                                        mixer, planar_params, spectral_unit,
                                        stores_bf16)
from ..ops.kernels.library import exporting, frozen
from ..ops.norm import BatchNorm2d
from ..ops.precision import check_dtype, widen


class SELayer(nn.Module):
    """Squeeze-excitation (reference squeeze_excitation.py:4-20; lama_tpu
    models/ffc.py:88-103): the channel means through Linear(C, C // 16) ->
    ReLU -> Linear(C // 16, C) -> sigmoid, scaling each channel. Keys:
    fc.0.weight, fc.2.weight (no biases). Computes in its input's dtype
    (float32 in the FourierUnit)."""

    def __init__(self, channels, reduction=16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid())

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = torch.relu(F.linear(y, self.fc[0].weight.to(y.dtype)))
        y = torch.sigmoid(F.linear(y, self.fc[2].weight.to(y.dtype)))
        return x * y[:, :, None, None]


class FFCSE_block(nn.Module):
    """Squeeze-excitation over the concatenated (local, global) streams
    with a gate back to each (reference ffc.py:16-46; lama_tpu
    models/ffc.py:106-133). Keys: conv1, conv_a2l, conv_a2g (1x1 with
    biases; the conv of an absent stream is None). Its convs take `mode`,
    as lama_tpu's do. No generator builds it."""

    def __init__(self, channels, ratio_g, kernels='cuda', mode=DEFAULT_MODE):
        super().__init__()
        in_cg = int(channels * ratio_g)
        in_cl = channels - in_cg
        r = 16

        def conv(cin, cout):
            return Conv2d(cin, cout, kernel_size=1, bias=True,
                          kernels=kernels, mode=mode)

        self.conv1 = conv(channels, channels // r)
        self.conv_a2l = None if in_cl == 0 else conv(channels // r, in_cl)
        self.conv_a2g = None if in_cg == 0 else conv(channels // r, in_cg)

    def forward(self, x):
        id_l, id_g = x if isinstance(x, tuple) else (x, None)
        joined = id_l if id_g is None else torch.cat([id_l, id_g], dim=1)
        y = torch.relu(self.conv1(joined.mean(dim=(2, 3), keepdim=True)))
        x_l = (None if self.conv_a2l is None
               else id_l * torch.sigmoid(self.conv_a2l(y)))
        x_g = (None if self.conv_a2g is None
               else id_g * torch.sigmoid(self.conv_a2g(y)))
        return x_l, x_g


class FourierUnit(nn.Module):
    """rfft2 -> 1x1 conv over interleaved re/im channels -> BN -> ReLU ->
    irfft2 (reference ffc.py:49-113; lama_tpu models/ffc.py:136-330). Keys:
    conv_layer.weight, bn.*, and se.fc.{0,2}.weight with `use_se`. Its
    conv_layer is never quantized (lama_tpu keeps the spectral conv out of
    int8 serving).

    The options, as lama_tpu's: `fft_norm` (torch.fft's 'ortho',
    'backward' or 'forward'); `spatial_scale_factor` and
    `spatial_scale_mode` (the input resized by the factor, the unit run at
    that size, its output resized back to the input's size);
    `spectral_pos_encoding` (two coordinate planes, linspace(0, 1, H) and
    linspace(0, 1, Wf), in front of the spectrum, so the conv takes 2C + 2
    channels); `use_se` (an SELayer on the spectrum before the conv);
    `groups` (a grouped spectral conv); `ffc3d` (the real FFT over C, H
    and W).

    The route is chosen in `forward`, by mode, option and shape, never by
    a failure:
    - train mode, or any of spectral_pos_encoding, use_se, groups > 1 or
      ffc3d: the unit in plain PyTorch (`spectral_unit`; cuFFT on the
      card), as lama_tpu keeps its fused kernel off those (models/ffc.py:
      196-198); train mode with batch-statistics BN;
    - eval, past the kernel's envelope (`kernel_fits` false, a side over
      256 at the size the unit runs): `fourier_unit_fft` (cuFFT), as
      lama_tpu takes jnp.fft there (ffc.py:229-231);
    - eval otherwise: kernel 1 (`fused_fourier_unit`), which folds BN into
      the conv once per set of weights (`planar_params`) and keeps the
      result, or its plain version under kernels='plain'. With
      mode.spectral_bf16_store the unit rounds its four DFT stage outputs
      to bf16 and stores them so (ops/kernels/fourier_unit.py
      `store_bf16`), on this route and on the plain PyTorch one where
      lama_tpu's DFT path runs (not ffc3d)."""

    def __init__(self, in_channels, out_channels, groups=1,
                 spatial_scale_factor=None, spatial_scale_mode='bilinear',
                 spectral_pos_encoding=False, use_se=False, ffc3d=False,
                 fft_norm='ortho', kernels='cuda', mode=DEFAULT_MODE):
        super().__init__()
        self.kernels = check_kernels(kernels)
        self.mode = mode
        self.groups = groups
        self.spatial_scale_factor = spatial_scale_factor
        self.spatial_scale_mode = spatial_scale_mode
        self.spectral_pos_encoding = spectral_pos_encoding
        self.ffc3d = ffc3d
        self.fft_norm = check_norm(fft_norm)
        # lama_tpu's fused-kernel gate (models/ffc.py:196-198)
        self.kernel_route = not (spectral_pos_encoding or use_se
                                 or groups != 1 or ffc3d)
        self.conv_layer = nn.Conv2d(
            in_channels * 2 + (2 if spectral_pos_encoding else 0),
            out_channels * 2, 1, groups=groups, bias=False)
        self.se = SELayer(self.conv_layer.in_channels) if use_se else None
        self.bn = BatchNorm2d(out_channels * 2)
        self._planar_key = None
        self._planar = None
        # the folded weights a program exported from this module reads as
        # constants (`freeze_for_export`); not part of the state dict
        self.register_buffer('export_planar_weight', None, persistent=False)
        self.register_buffer('export_planar_bias', None, persistent=False)

    def _params(self):
        return (self.conv_layer.weight, self.bn.weight, self.bn.bias,
                self.bn.running_mean, self.bn.running_var)

    def planar(self):
        """(W, bias) of `planar_params`, recomputed only when a parameter
        changed: an in-place update (a load, an optimizer step) bumps a
        tensor's version, a move to another device changes its storage.
        Inference tensors (made under torch.inference_mode) keep no version;
        for them only the storage counts. Train mode drops the cache (see
        `train`), since a train-mode forward moves the BN statistics inside
        PyTorch's batch norm."""
        key = tuple((t.data_ptr(), -1 if t.is_inference() else t._version)
                    for t in self._params())
        if key != self._planar_key:
            self._planar = planar_params(*self._params(), eps=self.bn.eps)
            self._planar_key = key
        return self._planar

    def freeze_for_export(self):
        """Fill the export buffers with `planar()` of the current weights,
        so a program exported after this call reads the folded weights as
        constants instead of folding them at every call."""
        if self.kernels != 'plain' and self.kernel_route:
            self.export_planar_weight, self.export_planar_bias = self.planar()

    def train(self, mode=True):
        self._planar_key = None
        return super().train(mode)

    def forward(self, x):
        size = tuple(x.shape[-2:])
        y = x
        if self.spatial_scale_factor is not None:
            y = interpolate(x, scale_factor=self.spatial_scale_factor,
                            mode=self.spatial_scale_mode, align_corners=False)
        out = self._unit(y)
        if self.spatial_scale_factor is not None:
            out = interpolate(out, size=size, mode=self.spatial_scale_mode,
                              align_corners=False)
        return out.to(x.dtype)

    def _unit(self, x):
        """The unit at x's size, by the route of the class docstring."""
        store_bf16 = self.mode.spectral_bf16_store
        if self.training or not self.kernel_route:
            return self._plain_unit(x, store_bf16)
        if not kernel_fits(*x.shape[-2:]):
            return fourier_unit_fft(x, *self._params(), eps=self.bn.eps,
                                    norm=self.fft_norm)
        if self.kernels == 'plain':
            return fourier_unit_plain(x, *self._params(), eps=self.bn.eps,
                                      store_bf16=store_bf16,
                                      norm=self.fft_norm)
        # exporting: the parameters have no storage to key the cache on;
        # the program reads the export buffers as constants
        planar = (frozen(self, 'export_planar_weight', 'export_planar_bias')
                  if exporting() else self.planar())
        return fused_fourier_unit(x, *self._params(), eps=self.bn.eps,
                                  planar=planar, store_bf16=store_bf16,
                                  norm=self.fft_norm)

    def _plain_unit(self, x, store_bf16):
        """lama_tpu's unit outside its fused kernel (ffc.py:211-330): the
        positional encoding and SE before the (grouped) conv, this
        module's BN (train or eval), ReLU."""
        conv = mixer(self.conv_layer.weight, self.bn, self.groups)

        def mix(y):
            if self.spectral_pos_encoding:
                b, _, h, wf = y.shape
                v = torch.linspace(0, 1, h, dtype=y.dtype, device=y.device)
                u = torch.linspace(0, 1, wf, dtype=y.dtype, device=y.device)
                y = torch.cat([v[None, None, :, None].expand(b, 1, h, wf),
                               u[None, None, None, :].expand(b, 1, h, wf),
                               y], dim=1)
            if self.se is not None:
                y = self.se(y)
            return conv(y)
        return spectral_unit(x, mix, self.fft_norm,
                             not self.ffc3d and stores_bf16(x, store_bf16),
                             self.ffc3d)


class SpectralTransform(nn.Module):
    """Reference ffc.py:116-163 (lama_tpu models/ffc.py:333-374): 1x1 conv
    + BN + ReLU, FourierUnit, with `enable_lfu` the local Fourier unit (the
    first quarter of the channels, its 2x2 spatial tiles stacked on the
    channels, through a second FourierUnit, then tiled back 2x2), the
    residual sum, 1x1 conv. `groups` reaches both 1x1 convs and both
    units' spectral convs. Keys: conv1.0, conv1.1, fu, lfu, conv2."""

    def __init__(self, in_channels, out_channels, stride=1, groups=1,
                 enable_lfu=True, kernels='cuda', mode=DEFAULT_MODE,
                 **fu_kwargs):
        super().__init__()
        half = out_channels // 2
        self.downsample = (nn.AvgPool2d(kernel_size=2, stride=2)
                           if stride == 2 else nn.Identity())
        self.conv1 = nn.Sequential(
            Conv2d(in_channels, half, 1, groups=groups, bias=False,
                   kernels=kernels, mode=mode),
            BatchNorm2d(half), nn.ReLU())
        self.fu = FourierUnit(half, half, groups, kernels=kernels, mode=mode,
                              **fu_kwargs)
        # lama_tpu gives the LFU none of fu_kwargs (models/ffc.py:366)
        self.lfu = (FourierUnit(4 * (half // 4), half, groups,
                                kernels=kernels, mode=mode)
                    if enable_lfu else None)
        self.conv2 = Conv2d(half, out_channels, 1, groups=groups, bias=False,
                            kernels=kernels, mode=mode)

    def local_fourier(self, x):
        """The LFU term: x[:, :c // 4], its top and bottom halves stacked
        on the channels, then its left and right halves (lama_tpu's NHWC
        split and concatenate order), through `lfu`, tiled 2x2. An odd side
        does not split in two and raises, as lama_tpu's jnp.split does."""
        h, w = x.shape[2:]
        if h % 2 or w % 2:
            raise ValueError(f'LFU needs even sides: {h}x{w}')
        xs = x[:, :x.shape[1] // 4]
        xs = torch.cat(torch.split(xs, h // 2, dim=2), dim=1)
        xs = torch.cat(torch.split(xs, w // 2, dim=3), dim=1)
        return self.lfu(xs).repeat(1, 1, 2, 2)

    def forward(self, x):
        x = self.conv1(self.downsample(x))
        out = x + self.fu(x)
        if self.lfu is not None:
            out = out + self.local_fourier(x)
        return self.conv2(out)


class FFC(nn.Module):
    """Two-stream (local, global) convolution (reference ffc.py:166-225):
    l2l, l2g and g2l reflect convs (grouped with `groups`), and the g2g
    SpectralTransform (its groups `groups // 2`, lama_tpu
    models/ffc.py:468-470). `gated` (lama_tpu :413-423): a 1x1 `gate`
    conv (bias) from the concatenated streams to 2 channels, its sigmoid
    weighting the g2l term (channel 0) and the l2g term (channel 1)."""

    def __init__(self, in_channels, out_channels, kernel_size, ratio_gin,
                 ratio_gout, stride=1, padding=0, dilation=1, groups=1,
                 bias=False, enable_lfu=True, padding_type='reflect',
                 gated=False, kernels='cuda', mode=DEFAULT_MODE,
                 **spectral_kwargs):
        super().__init__()
        in_cg = int(in_channels * ratio_gin)
        in_cl = in_channels - in_cg
        out_cg = int(out_channels * ratio_gout)
        out_cl = out_channels - out_cg
        kw = dict(kernel_size=kernel_size, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, bias=bias,
                  padding_mode=padding_type, kernels=kernels, mode=mode)

        def conv(cin, cout):
            return (Conv2d(cin, cout, **kw) if cin > 0 and cout > 0
                    else nn.Identity())

        self.convl2l = conv(in_cl, out_cl)
        self.convl2g = conv(in_cl, out_cg)
        self.convg2l = conv(in_cg, out_cl)
        self.convg2g = (SpectralTransform(
            in_cg, out_cg, stride, 1 if groups == 1 else groups // 2,
            enable_lfu, kernels=kernels, mode=mode, **spectral_kwargs)
            if in_cg > 0 and out_cg > 0 else nn.Identity())
        # lama_tpu builds the gate whenever `gated` (the reference only
        # with both a global input and a local output)
        self.gate = (Conv2d(in_channels, 2, kernel_size=1, bias=True,
                            kernels=kernels, mode=mode) if gated else None)
        self.has = dict(l2l=in_cl > 0 and out_cl > 0,
                        l2g=in_cl > 0 and out_cg > 0,
                        g2l=in_cg > 0 and out_cl > 0,
                        g2g=in_cg > 0 and out_cg > 0)
        self.out_cl, self.out_cg = out_cl, out_cg

    def forward(self, x):
        x_l, x_g = x if isinstance(x, tuple) else (x, None)

        def add(acc, term):
            return term if acc is None else acc + term

        g2l_gate = l2g_gate = None
        if self.gate is not None:
            gates = torch.sigmoid(self.gate(ConcatTupleLayer()((x_l, x_g))))
            g2l_gate, l2g_gate = gates[:, 0:1], gates[:, 1:2]

        def gated(term, g):
            return term if g is None else term * g

        out_l = out_g = None
        if self.out_cl > 0:
            if self.has['l2l'] and x_l is not None:
                out_l = self.convl2l(x_l)
            if self.has['g2l'] and x_g is not None:
                out_l = add(out_l, gated(self.convg2l(x_g), g2l_gate))
        if self.out_cg > 0:
            if self.has['l2g'] and x_l is not None:
                out_g = gated(self.convl2g(x_l), l2g_gate)
            if self.has['g2g'] and x_g is not None:
                out_g = add(out_g, self.convg2g(x_g))
        return out_l, out_g


class FFC_BN_ACT(nn.Module):
    """FFC + per-stream BatchNorm + activation (reference ffc.py:228-255).
    Keys: ffc, bn_l, bn_g."""

    def __init__(self, in_channels, out_channels, kernel_size, ratio_gin,
                 ratio_gout, stride=1, padding=0, dilation=1, groups=1,
                 bias=False, activation='identity', padding_type='reflect',
                 enable_lfu=True, kernels='cuda', **kwargs):
        super().__init__()
        self.ffc = FFC(in_channels, out_channels, kernel_size, ratio_gin,
                       ratio_gout, stride, padding, dilation, groups, bias,
                       enable_lfu, padding_type=padding_type,
                       kernels=kernels, **kwargs)
        out_cg = int(out_channels * ratio_gout)
        out_cl = out_channels - out_cg
        self.bn_l = BatchNorm2d(out_cl) if out_cl > 0 else nn.Identity()
        self.bn_g = BatchNorm2d(out_cg) if out_cg > 0 else nn.Identity()
        self.act = get_activation(activation)

    def forward(self, x):
        x_l, x_g = self.ffc(x)
        if x_l is not None:
            x_l = self.act(self.bn_l(x_l))
        if x_g is not None:
            x_g = self.act(self.bn_g(x_g))
        return x_l, x_g


class LearnableSpatialTransformWrapper(nn.Module):
    """Reflect-pad by `pad_coef` of each side, rotate by the learnable
    `angle` (degrees), run `impl`, rotate back, crop (reference
    spatial_transform.py:7-41; lama_tpu models/ffc.py:521-554). Keys:
    `impl.*` and `angle` (1,), uniform in [0, angle_init_range) at init.
    `train_angle=False` stops the angle's gradient. A (local, global)
    tuple is transformed stream by stream. The rotations are the port's
    bilinear warp (ops/geometry.py::rotate), differentiable in the angle;
    each warped stream keeps its dtype, so a bf16 block stays on the bf16
    kernels."""

    def __init__(self, impl, pad_coef=0.5, angle_init_range=80.0,
                 train_angle=True):
        super().__init__()
        self.impl = impl
        self.pad_coef = pad_coef
        self.train_angle = train_angle
        self.angle = nn.Parameter(torch.rand(1) * angle_init_range)

    def _pads(self, t):
        h, w = t.shape[-2:]
        return int(h * self.pad_coef), int(w * self.pad_coef)

    def forward(self, x):
        angle = self.angle if self.train_angle else self.angle.detach()

        def transform(t):
            ph, pw = self._pads(t)
            return rotate(pad2d(t, ((ph, ph), (pw, pw)), mode='reflect'),
                          angle).to(t.dtype)

        def inverse(t, orig):
            ph, pw = self._pads(orig)
            t = rotate(t, -angle).to(t.dtype)
            return t[:, :, ph:t.shape[2] - ph, pw:t.shape[3] - pw]

        if isinstance(x, tuple):
            y = self.impl(tuple(None if e is None else transform(e)
                                for e in x))
            return tuple(None if e is None else inverse(e, o)
                         for e, o in zip(y, x))
        return inverse(self.impl(transform(x)), x)


class FFCResnetBlock(nn.Module):
    """Two 3x3 FFC_BN_ACT with a residual on both streams (reference
    ffc.py:258-292; lama_tpu models/ffc.py:557-603). Keys: conv1, conv2.
    `inline` takes and returns one tensor, its last int(dim * ratio_gin)
    channels the global stream, as the pix2pixHD generators'
    `ffc_positions` blocks and the generator's `out_ffc` block do."""

    def __init__(self, dim, padding_type='reflect', activation='relu',
                 dilation=1, ratio_gin=0.75, ratio_gout=0.75,
                 enable_lfu=True, inline=False, kernels='cuda',
                 **spectral_kwargs):
        super().__init__()
        kw = dict(kernel_size=3, ratio_gin=ratio_gin, ratio_gout=ratio_gout,
                  padding=dilation, dilation=dilation, activation=activation,
                  padding_type=padding_type, enable_lfu=enable_lfu,
                  kernels=kernels, **spectral_kwargs)
        self.conv1 = FFC_BN_ACT(dim, dim, **kw)
        self.conv2 = FFC_BN_ACT(dim, dim, **kw)
        self.global_in = int(dim * ratio_gin) if inline else None

    def forward(self, x):
        if self.global_in is not None:
            g = self.global_in
            x = (x[:, :-g], x[:, -g:]) if g else (x, None)
        id_l, id_g = x if isinstance(x, tuple) else (x, None)
        x_l, x_g = self.conv2(self.conv1((id_l, id_g)))

        def residual(ident, y):
            if ident is None:
                return y
            # y first: a sum takes its first operand's memory format, and on
            # the kernel path y is channels-last while the stem and
            # downsamples (reflect pad + stock conv) hand over NCHW
            return ident if y is None else y + ident

        out = residual(id_l, x_l), residual(id_g, x_g)
        if self.global_in is not None:
            return ConcatTupleLayer()(out)
        return out


class ConcatTupleLayer(nn.Module):
    """(local, global) -> one tensor along channels (reference
    ffc.py:295-302)."""

    def forward(self, x):
        if not isinstance(x, tuple):
            return x
        x_l, x_g = x
        if x_g is None:
            return x_l
        if x_l is None:
            return x_g
        return torch.cat([x_l, x_g], dim=1)


class _Activation(nn.Module):
    def __init__(self, kind, float32=False):
        super().__init__()
        self.fn = get_activation(kind)
        self.float32 = float32

    def forward(self, x):
        return self.fn(widen(x) if self.float32 else x)


class FFCResNetGenerator(nn.Module):
    """The LaMa generator (reference ffc.py:305-367; lama_tpu
    models/ffc.py:618), NCHW. big-lama: input_nc=4, ngf=64,
    n_downsampling=3, n_blocks=18, resnet ratio 0.75, add_out_act='sigmoid'.

    `self.model` is an nn.Sequential with the reference's indices. As in the
    JAX package, the two ReflectionPad2d(3) entries are folded into the 7x7
    convs that follow them (padding=3, reflect); their indices hold a
    parameterless Identity. The blocks listed in `spatial_transform_layers`
    are wrapped in a LearnableSpatialTransformWrapper
    (`spatial_transform_kwargs`; keys `model.N.impl.*`, `model.N.angle`);
    `out_ffc` adds an inline FFCResnetBlock at ngf channels
    (`out_ffc_kwargs`: ratio_gin, ratio_gout, enable_lfu) after the
    upsampling, which moves the head one index on. The output activation, if any, runs in float32.
    `mode` (ops/serving_mode.py) is the serving configuration every conv
    and FourierUnit of the tree takes (int8, zero_pad, spectral_bf16_store;
    s2d and xfold_stem are carried and change nothing here).
    """

    def __init__(self, input_nc=4, output_nc=3, ngf=64, n_downsampling=3,
                 n_blocks=18, padding_type='reflect', activation='relu',
                 up_activation='relu', init_conv_kwargs=None,
                 downsample_conv_kwargs=None, resnet_conv_kwargs=None,
                 spatial_transform_layers: Optional[Sequence[int]] = None,
                 spatial_transform_kwargs=None, add_out_act=True,
                 max_features=1024, out_ffc=False, out_ffc_kwargs=None,
                 spectral_kwargs=None, dtype=torch.float32, kernels='cuda',
                 mode=DEFAULT_MODE):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.n_downsampling = n_downsampling
        init_kw = dict(init_conv_kwargs or {})
        down_kw = dict(downsample_conv_kwargs or {})
        res_kw = dict(resnet_conv_kwargs or {})
        self.mode = mode
        common = dict(kernels=kernels, mode=mode, **(spectral_kwargs or {}))

        layers = [nn.Identity(),   # 0: ReflectionPad2d(3), folded into 1
                  FFC_BN_ACT(input_nc, ngf, kernel_size=7, padding=3,
                             ratio_gin=init_kw.get('ratio_gin', 0),
                             ratio_gout=init_kw.get('ratio_gout', 0),
                             enable_lfu=init_kw.get('enable_lfu', True),
                             activation=activation,
                             padding_type=padding_type, **common)]
        for i in range(n_downsampling):
            mult = 2 ** i
            ratio_gout = (res_kw.get('ratio_gin', 0) if i == n_downsampling - 1
                          else down_kw.get('ratio_gout', 0))
            layers.append(FFC_BN_ACT(
                min(max_features, ngf * mult),
                min(max_features, ngf * mult * 2),
                kernel_size=3, stride=2, padding=1,
                ratio_gin=down_kw.get('ratio_gin', 0), ratio_gout=ratio_gout,
                enable_lfu=down_kw.get('enable_lfu', True),
                activation=activation, padding_type=padding_type, **common))
        feats = min(max_features, ngf * 2 ** n_downsampling)
        for i in range(n_blocks):
            block = FFCResnetBlock(
                feats, padding_type=padding_type, activation=activation,
                ratio_gin=res_kw.get('ratio_gin', 0.75),
                ratio_gout=res_kw.get('ratio_gout', 0.75),
                enable_lfu=res_kw.get('enable_lfu', True), **common)
            if spatial_transform_layers is not None \
                    and i in spatial_transform_layers:
                block = LearnableSpatialTransformWrapper(
                    block, **(spatial_transform_kwargs or {}))
            layers.append(block)
        layers.append(ConcatTupleLayer())
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            layers += [
                ConvTranspose2d(min(max_features, ngf * mult),
                                min(max_features, int(ngf * mult / 2)),
                                kernel_size=3, stride=2, padding=1,
                                output_padding=1, kernels=kernels, mode=mode),
                BatchNorm2d(min(max_features, int(ngf * mult / 2))),
                _Activation(up_activation)]
        if out_ffc:
            out_kw = dict(out_ffc_kwargs or {})
            layers.append(FFCResnetBlock(
                ngf, padding_type=padding_type, activation=activation,
                inline=True, ratio_gin=out_kw.get('ratio_gin', 0.75),
                ratio_gout=out_kw.get('ratio_gout', 0.75),
                enable_lfu=out_kw.get('enable_lfu', True), **common))
        layers += [nn.Identity(),  # ReflectionPad2d(3), folded into the head
                   Conv2d(ngf, output_nc, kernel_size=7, padding=3,
                          padding_mode='reflect', kernels=kernels,
                          mode=mode)]
        if add_out_act:
            layers.append(_Activation(
                'tanh' if add_out_act is True else add_out_act, float32=True))
        self.model = nn.Sequential(*layers)

    def _cast(self, x):
        return x.to(self.dtype).contiguous(memory_format=torch.channels_last)

    def forward(self, x, stage='full'):
        """stage 'full': (B, input_nc, H, W) -> (B, output_nc, H, W), float32
        when an output activation is set, else `dtype`. 'front': the stem and
        the downsamples, returning the (local, global) tuple after the last
        downsample. 'rear': that tuple through the blocks, the upsampling and
        the head. As in lama_tpu (models/ffc.py:658-701), the three stages
        share one set of parameters. Works channels-last."""
        split = 2 + self.n_downsampling
        if stage == 'rear':
            return self.model[split:](tuple(
                None if t is None else self._cast(t) for t in x))
        if stage == 'front':
            return self.model[:split](self._cast(x))
        if stage != 'full':
            raise ValueError(f'stage={stage!r}: expected full, front or rear')
        return self.model(self._cast(x))


class FFCNLayerDiscriminator(nn.Module):
    """The FFC PatchGAN discriminator (reference ffc.py:370-433; lama_tpu
    models/ffc.py:764-817): `model0` an FFC_BN_ACT 3x3 stride 1, `model1
    .. model{n-1}` 3x3 stride 2, `model{n}` 3x3 stride 1 and the
    ConcatTupleLayer, each with leaky ReLU 0.2 and reflect padding (so
    their convs go through the kernel dispatch of ops/conv.py), then
    `model{n+1}` the zero-padded 3x3 score conv with a bias. Keys as the
    reference's: `model0.0.ffc.convl2l.weight`, `model1.0.bn_l.running_mean`,
    `model5.0.bias`. `forward(x) -> (score (B, 1, h, w), [the output of
    each FFC layer, streams concatenated])`. Runs channels-last in `dtype`.
    """

    def __init__(self, input_nc=3, ndf=64, n_layers=3, max_features=512,
                 init_conv_kwargs=None, conv_kwargs=None, dtype=torch.float32,
                 kernels='cuda'):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.n_layers = n_layers
        init_kw = dict(init_conv_kwargs or {})
        conv_kw = dict(conv_kwargs or {})

        def layer(cin, cout, stride, kw):
            return FFC_BN_ACT(cin, cout, kernel_size=3, stride=stride,
                              padding=1, ratio_gin=kw.get('ratio_gin', 0),
                              ratio_gout=kw.get('ratio_gout', 0),
                              enable_lfu=kw.get('enable_lfu', True),
                              activation='leaky_relu', kernels=kernels)

        self.model0 = nn.Sequential(layer(input_nc, ndf, 1, init_kw))
        nf = ndf
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, max_features)
            setattr(self, f'model{n}', nn.Sequential(
                layer(nf_prev, nf, 2, conv_kw)))
        nf_prev, nf = nf, min(nf * 2, 512)
        setattr(self, f'model{n_layers}', nn.Sequential(
            layer(nf_prev, nf, 1, conv_kw), ConcatTupleLayer()))
        setattr(self, f'model{n_layers + 1}', nn.Sequential(
            Conv2d(nf, 1, kernel_size=3, padding=1, kernels=kernels)))

    def forward(self, x):
        h = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        feats = []
        for n in range(self.n_layers + 1):
            h = getattr(self, f'model{n}')(h)
            feats.append(ConcatTupleLayer()(h))
        return getattr(self, f'model{self.n_layers + 1}')(feats[-1]), feats
