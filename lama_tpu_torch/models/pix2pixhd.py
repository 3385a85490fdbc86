"""The pix2pixHD family: the PatchGAN discriminator the LaMa configs train
against, and the conv-ResNet GlobalGenerator of lama-regular and
big-lama-regular (counterparts of lama_tpu/models/pix2pixhd.py:
NLayerDiscriminator :410-453, ResnetBlock :142-188, GlobalGenerator
:217-326; reference pix2pixhd.py:565-613, :30-92, :341-436).

The module trees mirror the reference key-space, so a reference-format
state_dict loads with `strict=True`:
- NLayerDiscriminator: `model0` (conv, LeakyReLU), `model1..model{n-1}`
  (stride-2 conv, BN, LeakyReLU), `model{n}` (stride-1 conv, BN, LeakyReLU)
  and `model{n+1}` (the 1-channel score conv): `model0.0.weight`,
  `model1.1.running_mean`, ... Its convs are 4x4 with zero padding 2.
- GlobalGenerator: `model.N`, e.g. `model.1.weight` (the 7x7 stem),
  `model.10.conv_block.5.weight` (a ResnetBlock's second conv). As in the
  JAX package, each reflection pad of the reference's Sequentials is folded
  into the conv that follows it (`padding_mode='reflect'`), so that conv
  goes through the kernel dispatch of ops/conv.py; the pad's index holds a
  parameterless Identity, and the ResnetBlock keeps its conv and BN indices
  (`conv_block.1, 2, 5, 6`) whatever the padding type, as the JAX names do.
Every parameter stays float32; a model runs in its `dtype` (float32 or
bfloat16; float64 for reference checks), BatchNorm and the output activation
compute in float32. `kernels='plain'` sends the kernels' shapes to their
plain versions. The GlobalGenerator's `mode` (ops/serving_mode.py) reaches
its convs: under int8 the eligible ones quantize (the downsamples, the
ResnetBlock convs and the ConvTranspose layers), with the pads placed as in
lama_tpu (each ResnetBlock pad folded into its conv, so zero_pad turns it
to zeros; the downsamples are zero-padded with or without it). Options no
shipped config uses raise NotImplementedError naming the ROADMAP item that
ports them.
"""
import torch
import torch.nn as nn

from ..ops.activations import leaky_relu_02
from ..ops.conv import Conv2d, ConvTranspose2d
from ..ops.norm import BatchNorm2d
from ..ops.precision import check_dtype
from ..ops.serving_mode import DEFAULT as DEFAULT_MODE
from .ffc import _Activation

_LATER = 'not ported yet (ROADMAP queue 1 item 12)'


class _LeakyReLU(nn.Module):
    def forward(self, x):
        return leaky_relu_02(x)


class NLayerDiscriminator(nn.Module):
    """(B, input_nc, H, W) -> (score (B, 1, h, w), [the outputs of stages
    0..n_layers]), the features feature matching compares
    (trainers/default.py:128)."""

    def __init__(self, input_nc=3, ndf=64, n_layers=3, dtype=torch.float32,
                 kernels='cuda'):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.n_layers = n_layers
        kw = dict(kernel_size=4, padding=2, kernels=kernels)
        self.model0 = nn.Sequential(Conv2d(input_nc, ndf, stride=2, **kw),
                                    _LeakyReLU())
        nf = ndf
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            setattr(self, f'model{n}', nn.Sequential(
                Conv2d(nf_prev, nf, stride=2, **kw), BatchNorm2d(nf),
                _LeakyReLU()))
        nf_prev, nf = nf, min(nf * 2, 512)
        setattr(self, f'model{n_layers}', nn.Sequential(
            Conv2d(nf_prev, nf, stride=1, **kw), BatchNorm2d(nf),
            _LeakyReLU()))
        setattr(self, f'model{n_layers + 1}', nn.Sequential(
            Conv2d(nf, 1, stride=1, **kw)))

    def forward(self, x):
        h = x.to(self.dtype)
        feats = []
        for n in range(self.n_layers + 1):
            h = getattr(self, f'model{n}')(h)
            feats.append(h)
        return getattr(self, f'model{self.n_layers + 1}')(h), feats


class ResnetBlock(nn.Module):
    """conv -> BN -> activation -> conv -> BN, plus the residual (reference
    pix2pixhd.py:30-92; lama_tpu pix2pixhd.py:142-188). padding_type
    reflect, replicate or zero; kernel_size 3 or 5 (which doubles the pad);
    `in_dim` adds the 1x1 `input_conv` on the residual. Keys:
    conv_block.{1,2,5,6}, input_conv."""

    def __init__(self, dim, padding_type='reflect', activation='relu',
                 conv_kind='default', dilation=1, second_dilation=None,
                 in_dim=None, groups=1, kernel_size=3, kernels='cuda',
                 mode=DEFAULT_MODE):
        super().__init__()
        if conv_kind == 'depthwise':
            raise NotImplementedError(f'conv_kind={conv_kind!r} '
                                      f'(DepthWiseSeparableConv) is {_LATER}')
        if second_dilation is None:
            second_dilation = dilation
        pad_mult = 2 if kernel_size == 5 else 1
        pad_mode = {'reflect': 'reflect', 'replicate': 'replicate'}.get(
            padding_type, 'zeros')

        def conv(cin, d, g):
            return Conv2d(cin, dim, kernel_size, padding=d * pad_mult,
                          dilation=d, groups=g, padding_mode=pad_mode,
                          kernels=kernels, mode=mode)

        self.conv_block = nn.Sequential(
            nn.Identity(),   # 0: the first pad, folded into 1
            conv(dim if in_dim is None else in_dim, dilation, 1),
            BatchNorm2d(dim), _Activation(activation),
            nn.Identity(),   # 4: the second pad, folded into 5
            conv(dim, second_dilation, groups), BatchNorm2d(dim))
        self.input_conv = (None if in_dim is None else
                           Conv2d(in_dim, dim, 1, kernels=kernels,
                                  mode=mode))

    def forward(self, x):
        skip = x if self.input_conv is None else self.input_conv(x)
        # the block's output first: a sum takes its first operand's memory
        # format, and the kernels return channels-last
        return self.conv_block(x) + skip


class GlobalGenerator(nn.Module):
    """The pix2pixHD conv-ResNet generator (reference pix2pixhd.py:341-436;
    lama_tpu pix2pixhd.py:217-326), `kind='pix2pixhd_global'`, NCHW.
    big-lama-regular: input_nc=4, ngf=64, n_downsampling=3, n_blocks=18,
    add_out_act='sigmoid' (lama-regular: 9 blocks).

    `self.model` is an nn.Sequential with the reference's indices: 0 pad,
    1 the 7x7 stem conv, 2 BN, 3 activation; each downsample (3x3 stride 2,
    zero padding) conv, BN, activation; the dilated and plain ResnetBlocks
    at max_features-capped width; each upsample ConvTranspose, BN,
    up_activation; a pad index, the 7x7 head conv, and the output
    activation, which runs in float32."""

    def __init__(self, input_nc=4, output_nc=3, ngf=64, n_downsampling=3,
                 n_blocks=9, padding_type='reflect', conv_kind='default',
                 activation='relu', up_activation='relu', dilated_blocks_n=0,
                 dilated_blocks_n_start=0, dilated_blocks_n_middle=0,
                 add_out_act=True, max_features=1024,
                 is_resblock_depthwise=False, ffc_positions=None,
                 ffc_kwargs=None, dilation=1, second_dilation=None,
                 dtype=torch.float32, kernels='cuda', mode=DEFAULT_MODE):
        super().__init__()
        for name, value in (('ffc_positions', ffc_positions),
                            ('is_resblock_depthwise', is_resblock_depthwise)):
            if value:
                raise NotImplementedError(f'{name}={value!r} is {_LATER}')
        self.dtype = check_dtype(dtype)
        self.mode = mode

        layers = [nn.Identity(),   # 0: ReflectionPad2d(3), folded into 1
                  Conv2d(input_nc, ngf, 7, padding=3, padding_mode='reflect',
                         kernels=kernels, mode=mode),
                  BatchNorm2d(ngf), _Activation(activation)]
        for i in range(n_downsampling):
            mult = 2 ** i
            cin = min(max_features, ngf * mult)
            cout = min(max_features, ngf * mult * 2)
            layers += [Conv2d(cin, cout, 3, stride=2, padding=1,
                              kernels=kernels, mode=mode),
                       BatchNorm2d(cout), _Activation(activation)]
        feats = min(max_features, ngf * 2 ** n_downsampling)
        block = dict(padding_type=padding_type, activation=activation,
                     conv_kind=conv_kind, kernels=kernels, mode=mode)

        def dilated_blocks(n):
            return [ResnetBlock(feats, dilation=2 ** (j + 1), **block)
                    for j in range(n)]

        layers += dilated_blocks(dilated_blocks_n_start)
        for i in range(n_blocks):
            if i == n_blocks // 2:
                layers += dilated_blocks(dilated_blocks_n_middle)
            layers.append(ResnetBlock(feats, dilation=dilation,
                                      second_dilation=second_dilation,
                                      **block))
        layers += dilated_blocks(dilated_blocks_n)
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            cout = min(max_features, int(ngf * mult / 2))
            layers += [ConvTranspose2d(min(max_features, ngf * mult), cout,
                                       kernel_size=3, stride=2, padding=1,
                                       output_padding=1, kernels=kernels,
                                       mode=mode),
                       BatchNorm2d(cout), _Activation(up_activation)]
        layers += [nn.Identity(),  # ReflectionPad2d(3), folded into the head
                   Conv2d(ngf, output_nc, 7, padding=3, padding_mode='reflect',
                          kernels=kernels, mode=mode)]
        if add_out_act:
            layers.append(_Activation(
                'tanh' if add_out_act is True else add_out_act, float32=True))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        """(B, input_nc, H, W) -> (B, output_nc, H, W): float32 when an
        output activation is set, else `dtype`. Works channels-last."""
        return self.model(x.to(self.dtype).contiguous(
            memory_format=torch.channels_last))
