"""The experimental pix2pixHD generators (counterpart of
lama_tpu/models/pix2pixhd_extra.py; reference pix2pixhd.py:239-561,
667-669 and base.py:53-79): the gated conv, the generator built from
manual block specs (`kind='config_global'`), the supernet channel schedule
(`kind='super_channels'`), the discriminator used as a generator and the
multi-step generator.

NCHW modules with the reference's keys, as models/pix2pixhd.py: `model.N`
Sequentials with the GlobalGenerator's indices. lama_tpu pads the 7x7 stem
and head with an explicit reflection pad and a padding-0 conv; here each
pad is folded into its conv (padding 3, reflect), its index an Identity,
so the stem and the head take kernels 7 and 5 as the GlobalGenerator's do:
the same numbers. Every parameter float32, computing in `dtype`;
`kernels` and `mode` reach every conv.
"""
import torch
import torch.nn as nn

from ..ops.conv import Conv2d, ConvTranspose2d
from ..ops.norm import BatchNorm2d
from ..ops.precision import check_dtype
from ..ops.resize import interpolate
from ..ops.serving_mode import DEFAULT as DEFAULT_MODE
from .ffc import _Activation
from .pix2pixhd import (DepthWiseSeparableConv, MultidilatedResnetBlock,
                        NLayerDiscriminator, ResnetBlock, _decoder, _encoder,
                        _Generator)


class GatedConv2d(nn.Module):
    """features x sigmoid(gates) of one conv with 2 x out_dim outputs
    (lama_tpu pix2pixhd_extra.py:26-45; the reference registers the kind
    but never defines its conv). Key: conv."""

    def __init__(self, in_dim, out_dim, kernel_size=3, stride=1, padding=0,
                 kernels='cuda', mode=DEFAULT_MODE):
        super().__init__()
        self.conv = Conv2d(in_dim, 2 * out_dim, kernel_size, stride=stride,
                           padding=padding, kernels=kernels, mode=mode)

    def forward(self, x):
        feat, gate = torch.chunk(self.conv(x), 2, dim=1)
        return feat * torch.sigmoid(gate)


class _Upsample(nn.Module):
    def forward(self, x):
        return interpolate(x, scale_factor=2, mode='bilinear')


_BLOCK_KINDS = ('multidilatedresnetblock', 'resnetblock', 'resnetblock5x5',
                'resnetblockdwdil')


class ConfigGlobalGenerator(_Generator):
    """The generator of manual per-segment block specs (reference
    pix2pixhd.py:239-331; lama_tpu pix2pixhd_extra.py:48-167),
    `kind='config_global'`. Each entry of `manual_block_spec` (default: one
    segment of n_blocks default blocks) names n_blocks and, unless
    use_default, its resnet_block_kind (multidilatedresnetblock,
    resnetblock, resnetblock5x5 or resnetblockdwdil), resnet_conv_kind,
    resnet_dilation and multidilation_kwargs. deconv_kind 'convtranspose'
    (GlobalGenerator's upsamples) or 'bilinear' (x2 bilinear, then a
    DepthWiseSeparableConv, BN, activation: four indices)."""

    def __init__(self, input_nc=4, output_nc=3, ngf=64, n_downsampling=3,
                 n_blocks=3, padding_type='reflect', conv_kind='default',
                 deconv_kind='convtranspose', activation='relu',
                 up_activation='relu', add_out_act=True, max_features=1024,
                 manual_block_spec=(),
                 resnet_block_kind='multidilatedresnetblock',
                 resnet_conv_kind='multidilated', resnet_dilation=1,
                 multidilation_kwargs=None, dtype=torch.float32,
                 kernels='cuda', mode=DEFAULT_MODE):
        super().__init__()
        if deconv_kind not in ('convtranspose', 'bilinear'):
            raise ValueError(f'Invalid deconv kind: {deconv_kind}')
        self.dtype = check_dtype(dtype)
        self.mode = mode
        layers = _encoder(input_nc, ngf, n_downsampling, max_features,
                          activation, kernels, mode)
        mult = 2 ** n_downsampling
        feats = min(max_features, ngf * mult)
        common = dict(padding_type=padding_type, activation=activation,
                      kernels=kernels, mode=mode)
        for spec in (list(manual_block_spec)
                     or [dict(n_blocks=n_blocks, use_default=True)]):
            spec = dict(spec)
            default = spec.get('use_default', False)
            block_kind = (resnet_block_kind if default else
                          spec.get('resnet_block_kind', resnet_block_kind))
            res_conv = (resnet_conv_kind if default else
                        spec.get('resnet_conv_kind', resnet_conv_kind))
            dilation = (resnet_dilation if default else
                        spec.get('resnet_dilation') or resnet_dilation)
            md_kwargs = (multidilation_kwargs if default else
                         spec.get('multidilation_kwargs',
                                  multidilation_kwargs))
            if block_kind not in _BLOCK_KINDS:
                raise ValueError(f'Unknown resnet block kind {block_kind}')
            for _ in range(int(spec.get('n_blocks', 0))):
                if block_kind == 'multidilatedresnetblock':
                    layers.append(MultidilatedResnetBlock(
                        feats, multidilation_kwargs=md_kwargs, **common))
                    continue
                kw = dict(conv_kind=res_conv, **common)
                if block_kind == 'resnetblock5x5':
                    kw['kernel_size'] = 5
                elif block_kind == 'resnetblockdwdil':
                    kw.update(dilation=dilation, second_dilation=dilation)
                layers.append(ResnetBlock(ngf * mult, **kw))
        if deconv_kind == 'convtranspose':
            layers += _decoder(output_nc, ngf, n_downsampling, max_features,
                               up_activation, add_out_act, kernels, mode)
        else:
            for i in range(n_downsampling):
                mult = 2 ** (n_downsampling - i)
                cout = min(max_features, int(ngf * mult / 2))
                layers += [_Upsample(),
                           DepthWiseSeparableConv(
                               min(max_features, ngf * mult), cout, 3,
                               padding=1, kernels=kernels, mode=mode),
                           BatchNorm2d(cout), _Activation(up_activation)]
            layers += _decoder(output_nc, ngf, 0, max_features,
                               up_activation, add_out_act, kernels, mode)
        self.model = nn.Sequential(*layers)


def convert_super_channels(super_channels, n_downsampling):
    """The supernet channel schedule (reference pix2pixhd.py:517-558; a
    copy of lama_tpu pix2pixhd_extra.py:170-199, which clamps the
    reference's out-of-range index on the third upsample)."""
    result = []
    cnt = 0
    if n_downsampling == 2:
        n1 = 10
    elif n_downsampling == 3:
        n1 = 13
    else:
        raise NotImplementedError
    for i in range(0, n1):
        if i in (1, 4, 7, 10):
            result.append(super_channels[cnt] * (2 ** cnt))
            cnt += 1
    for i in range(3):
        for counter, _ in enumerate(range(n1 + i * 3, n1 + 3 + i * 3)):
            channel = super_channels[3] * 4 if len(super_channels) == 6 \
                else super_channels[i + 3] * 4
            if counter == 0:
                result.append(channel)
    cnt = 2
    for i in range(n1 + 9, n1 + 21):
        if i in (22, 25, 28):
            cnt -= 1
            base = 5 if len(super_channels) == 6 else 7
            idx = min(base - cnt, len(super_channels) - 1)
            result.append(int(super_channels[idx] * (2 ** max(cnt, 0))))
    return result


class GlobalGeneratorFromSuperChannels(_Generator):
    """The generator of a supernet channel schedule (reference
    pix2pixhd.py:449-561; lama_tpu pix2pixhd_extra.py:202-261),
    `kind='super_channels'`: the stem and downsamples at the schedule's
    widths, three segments of ResnetBlocks (the first block of the second
    and third with a 1x1 `input_conv` from the previous width), the
    ConvTranspose upsamples and the head, ReLU throughout."""

    def __init__(self, input_nc=4, output_nc=3, n_downsampling=3,
                 n_blocks=9, super_channels=(64, 64, 64, 64, 64, 64),
                 padding_type='reflect', add_out_act=True,
                 dtype=torch.float32, kernels='cuda', mode=DEFAULT_MODE):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.mode = mode
        ch = convert_super_channels(list(super_channels), n_downsampling)
        nd = n_downsampling
        kw = dict(kernels=kernels, mode=mode)
        layers = [nn.Identity(),   # 0: ReflectionPad2d(3), folded into 1
                  Conv2d(input_nc, ch[0], 7, padding=3,
                         padding_mode='reflect', **kw),
                  BatchNorm2d(ch[0]), nn.ReLU()]
        for i in range(nd):
            layers += [Conv2d(ch[i], ch[1 + i], 3, stride=2, padding=1, **kw),
                       BatchNorm2d(ch[1 + i]), nn.ReLU()]
        n1 = n_blocks // 3
        segments = [(n1, ch[nd], None), (n1, ch[nd + 1], ch[nd]),
                    (n_blocks - 2 * n1, ch[nd + 2], ch[nd + 1])]
        for n, dim, in_dim in segments:
            layers += [ResnetBlock(dim, padding_type=padding_type,
                                   in_dim=in_dim if j == 0 else None, **kw)
                       for j in range(n)]
        cin = ch[nd + 2]
        for i in range(nd):
            cout = ch[nd + 3 + i + 1]
            layers += [ConvTranspose2d(cin, cout, kernel_size=3, stride=2,
                                       padding=1, output_padding=1, **kw),
                       BatchNorm2d(cout), nn.ReLU()]
            cin = cout
        layers += [nn.Identity(),  # ReflectionPad2d(3), folded into the head
                   Conv2d(cin, output_nc, 7, padding=3,
                          padding_mode='reflect', **kw)]
        if add_out_act:
            layers.append(_Activation(
                'tanh' if add_out_act is True else add_out_act, float32=True))
        self.model = nn.Sequential(*layers)


class NLayerDiscriminatorAsGen(nn.Module):
    """The PatchGAN body as a generator: its score map only (reference
    pix2pixhd.py:667-669; lama_tpu pix2pixhd_extra.py:264-279). Keys:
    impl.*. `mode` is accepted as lama_tpu does and serves nothing: the
    discriminator's convs stay unquantized."""

    def __init__(self, input_nc=3, ndf=64, n_layers=3, mode=DEFAULT_MODE,
                 dtype=torch.float32, kernels='cuda'):
        super().__init__()
        self.impl = NLayerDiscriminator(input_nc, ndf, n_layers, dtype,
                                        kernels)

    def forward(self, x):
        return self.impl(x)[0]


class SimpleMultiStepGenerator(nn.Module):
    """Runs `steps` in turn, each on the input and the earlier steps'
    outputs concatenated, and returns the outputs concatenated last first
    (reference base.py:53-65; lama_tpu pix2pixhd_extra.py:282-296). Keys:
    steps.{i}.*."""

    def __init__(self, steps):
        super().__init__()
        self.steps = nn.ModuleList(steps)

    def forward(self, x):
        outs = []
        for step in self.steps:
            outs.append(step(x))
            x = torch.cat([x, outs[-1]], dim=1)
        return torch.cat(outs[::-1], dim=1)
