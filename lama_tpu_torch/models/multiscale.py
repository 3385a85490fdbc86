"""The multiscale coarse-to-fine generator and discriminator (counterpart of
lama_tpu/models/multiscale.py; reference training/modules/multiscale.py:
11-244): per-scale ResNet heads, tails that take the coarser tail's
features, and a list of per-scale discriminators. No shipped config builds
them; they are part of the module surface.

NCHW modules with the reference's keys (`heads.{i}.model.N`,
`tails.{i}.model.N`, `tails.{i}.out_proj.N`, `discriminators.{i}.*`).
The 7x7 reflection pads of lama_tpu are folded into their convs (padding
3, reflect; the pad's index an Identity), so the stems and heads take
kernels 7 and 5, as models/pix2pixhd.py does: the same numbers. Every
parameter float32; a model computes in its `dtype`.
"""
from typing import List, Optional

import torch
import torch.nn as nn

from ..ops.conv import Conv2d, ConvTranspose2d
from ..ops.norm import BatchNorm2d
from ..ops.precision import check_dtype
from ..ops.resize import interpolate
from .ffc import _Activation
from .pix2pixhd import ResnetBlock


def _channels_last(x, dtype):
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


class ResNetHead(nn.Module):
    """The 7x7 reflect stem, n_downsampling stride-2 convs and n_blocks
    ResnetBlocks of one scale (reference multiscale.py:11-41). Keys:
    model.N."""

    def __init__(self, input_nc=4, ngf=64, n_downsampling=3, n_blocks=9,
                 padding_type='reflect', conv_kind='default',
                 activation='relu', dtype=torch.float32, kernels='cuda'):
        super().__init__()
        self.dtype = check_dtype(dtype)
        layers = [nn.Identity(),   # 0: ReflectionPad2d(3), folded into 1
                  Conv2d(input_nc, ngf, 7, padding=3, padding_mode='reflect',
                         kernels=kernels),
                  BatchNorm2d(ngf), _Activation(activation)]
        for i in range(n_downsampling):
            mult = 2 ** i
            layers += [Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                              padding=1, kernels=kernels),
                       BatchNorm2d(ngf * mult * 2), _Activation(activation)]
        mult = 2 ** n_downsampling
        layers += [ResnetBlock(ngf * mult, padding_type=padding_type,
                               activation=activation, conv_kind=conv_kind,
                               kernels=kernels) for _ in range(n_blocks)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(_channels_last(x, self.dtype))


class ResNetTail(nn.Module):
    """n_blocks ResnetBlocks (after a 1x1 projection from `add_in_proj`
    channels when given), the ConvTranspose upsamples, then `out_proj`:
    out_extra_layers_n 1x1 conv + BN + activation, the 7x7 reflect head and
    the output activation (reference multiscale.py:44-91). `forward(x,
    return_last_act)` also returns the features before out_proj."""

    def __init__(self, output_nc=3, ngf=64, n_downsampling=3, n_blocks=9,
                 padding_type='reflect', conv_kind='default',
                 activation='relu', up_activation='relu', add_out_act=False,
                 out_extra_layers_n=0, add_in_proj=None, dtype=torch.float32,
                 kernels='cuda'):
        super().__init__()
        self.dtype = check_dtype(dtype)
        mult = 2 ** n_downsampling
        layers = ([] if add_in_proj is None else
                  [Conv2d(add_in_proj, ngf * mult, 1, kernels=kernels)])
        layers += [ResnetBlock(ngf * mult, padding_type=padding_type,
                               activation=activation, conv_kind=conv_kind,
                               kernels=kernels) for _ in range(n_blocks)]
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            layers += [ConvTranspose2d(ngf * mult, int(ngf * mult / 2), 3,
                                       stride=2, padding=1, output_padding=1,
                                       kernels=kernels),
                       BatchNorm2d(int(ngf * mult / 2)),
                       _Activation(up_activation)]
        self.model = nn.Sequential(*layers)
        out = []
        for _ in range(out_extra_layers_n):
            out += [Conv2d(ngf, ngf, 1, kernels=kernels), BatchNorm2d(ngf),
                    _Activation(up_activation)]
        out += [nn.Identity(),   # ReflectionPad2d(3), folded into the head
                Conv2d(ngf, output_nc, 7, padding=3, padding_mode='reflect',
                       kernels=kernels)]
        if add_out_act:
            out.append(_Activation(
                'tanh' if add_out_act is True else add_out_act, float32=True))
        self.out_proj = nn.Sequential(*out)

    def forward(self, x, return_last_act=False):
        features = self.model(_channels_last(x, self.dtype))
        out = self.out_proj(features)
        return (out, features) if return_last_act else out


class MultiscaleResNet(nn.Module):
    """Per-scale heads and tails (reference multiscale.py:94-171). `forward
    (ms_inputs)`: a list of inputs from the finest scale to the coarsest;
    the coarsest tail runs first, and each finer tail takes its head's
    features with the coarser tail's (bilinearly resized) concatenated.
    Returns the outputs finest first (only the finest with
    return_only_hr); out_cumulative adds each coarser output, resized, to
    the next."""

    def __init__(self, input_nc=4, output_nc=3, ngf=64, n_downsampling=2,
                 n_blocks_head=2, n_blocks_tail=6, n_scales=3,
                 padding_type='reflect', conv_kind='default',
                 activation='relu', up_activation='relu', add_out_act=False,
                 out_extra_layers_n=0, out_cumulative=False,
                 return_only_hr=False, dtype=torch.float32, kernels='cuda'):
        super().__init__()
        common = dict(ngf=ngf, n_downsampling=n_downsampling,
                      padding_type=padding_type, conv_kind=conv_kind,
                      activation=activation, dtype=dtype, kernels=kernels)
        self.heads = nn.ModuleList(
            ResNetHead(input_nc, n_blocks=n_blocks_head, **common)
            for _ in range(n_scales))
        tail_in = ngf * 2 ** n_downsampling + ngf
        self.tails = nn.ModuleList(
            ResNetTail(output_nc, n_blocks=n_blocks_tail,
                       up_activation=up_activation, add_out_act=add_out_act,
                       out_extra_layers_n=out_extra_layers_n,
                       add_in_proj=None if i == n_scales - 1 else tail_in,
                       **common)
            for i in range(n_scales))
        self.out_cumulative = out_cumulative
        self.return_only_hr = return_only_hr

    def forward(self, ms_inputs: List, smallest_scales_num: Optional[int] = None):
        if smallest_scales_num is None:
            if len(ms_inputs) != len(self.heads):
                raise ValueError(f'{len(ms_inputs)} inputs for '
                                 f'{len(self.heads)} scales')
            smallest_scales_num = len(self.heads)
        elif not smallest_scales_num == len(ms_inputs) <= len(self.heads):
            raise ValueError(f'smallest_scales_num={smallest_scales_num} '
                             f'with {len(ms_inputs)} inputs')
        heads = list(self.heads)[-smallest_scales_num:]
        features = [head(x) for head, x in zip(heads, ms_inputs)]
        outputs, prev = [], None
        for i in range(len(features)):
            cur = features[-i - 1]
            if prev is not None:
                if prev.shape[2:] != cur.shape[2:]:
                    prev = interpolate(prev, size=tuple(cur.shape[2:]),
                                       mode='bilinear')
                cur = torch.cat([cur, prev], dim=1)
            out, prev = self.tails[-i - 1](cur, return_last_act=True)
            outputs.append(out)
        if self.out_cumulative:
            cum = [outputs[0]]
            for out in outputs[1:]:
                cum.append(out + interpolate(cum[-1], size=tuple(out.shape[2:]),
                                             mode='bilinear'))
            outputs = cum
        return outputs[-1] if self.return_only_hr else outputs[::-1]


class MultiscaleDiscriminatorSimple(nn.Module):
    """One discriminator a scale (reference multiscale.py:174-196):
    `forward(ms_inputs)` -> [each discriminator's (score, features)] for
    the last len(ms_inputs) of them. Keys: discriminators.{i}.*."""

    def __init__(self, discriminators):
        super().__init__()
        self.discriminators = nn.ModuleList(discriminators)

    def forward(self, ms_inputs: List, smallest_scales_num: Optional[int] = None):
        n = len(self.discriminators)
        if smallest_scales_num is None:
            if len(ms_inputs) != n:
                raise ValueError(f'{len(ms_inputs)} inputs for {n} scales')
            smallest_scales_num = n
        elif not smallest_scales_num == len(ms_inputs) <= n:
            raise ValueError(f'smallest_scales_num={smallest_scales_num} '
                             f'with {len(ms_inputs)} inputs')
        return [d(x) for d, x in zip(
            list(self.discriminators)[-smallest_scales_num:], ms_inputs)]


def make_multiscale_inputs(x, num_scales: int) -> List:
    """An NCHW tensor -> [it bilinearly resized to (h // 2^i, w // 2^i)],
    finest first (reference SingleToMultiScaleInputMixin,
    multiscale.py:199-205)."""
    h, w = x.shape[2:]
    return [interpolate(x, size=(h // 2 ** i, w // 2 ** i), mode='bilinear')
            for i in range(num_scales)]
