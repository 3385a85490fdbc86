"""The pix2pixHD family: the PatchGAN discriminators the LaMa configs train
against and the conv-ResNet generators (counterparts of
lama_tpu/models/pix2pixhd.py: DepthWiseSeparableConv :37-57,
MultidilatedConv :60-139, ResnetBlock :142-188, MultidilatedResnetBlock
:191-214, GlobalGenerator :217-326, MultiDilatedGlobalGenerator :329-407,
NLayerDiscriminator :410-453, MultidilatedNLayerDiscriminator :456-498;
reference pix2pixhd.py and multidilated_conv.py, depthwise_sep_conv.py).

The module trees mirror the reference key-space, so a reference-format
state_dict loads with `strict=True`:
- NLayerDiscriminator and MultidilatedNLayerDiscriminator: `model0`
  (conv, LeakyReLU), `model1..model{n-1}` (stride-2 conv, BN, LeakyReLU;
  a MultidilatedConv in the latter), `model{n}` (stride-1 conv, BN,
  LeakyReLU) and `model{n+1}` (the 1-channel score conv): `model0.0.weight`,
  `model1.0.convs.1.weight`, `model1.1.running_mean`, ... Their convs are
  4x4 with zero padding 2 (the multidilated ones [2, 3] by dilation).
- GlobalGenerator and MultiDilatedGlobalGenerator: `model.N`, e.g.
  `model.1.weight` (the 7x7 stem), `model.10.conv_block.5.weight` (a
  ResnetBlock's second conv), `model.10.conv_block.0.convs.2.weight` (a
  MultidilatedResnetBlock's first conv, its third dilation). As in the JAX
  package, each reflection pad of the reference's Sequentials is folded
  into the conv that follows it (`padding_mode='reflect'`), so that conv
  goes through the kernel dispatch of ops/conv.py; the pad's index holds a
  parameterless Identity, and the ResnetBlock keeps its conv and BN indices
  (`conv_block.1, 2, 5, 6`) whatever the padding type, as the JAX names do.
  `ffc_positions` puts inline FFCResnetBlocks (models/ffc.py) among the
  blocks, with LFU unless `ffc_kwargs` turns it off.
- MultidilatedConv: `convs.{i}` (each a Conv2d, or a DepthWiseSeparableConv
  with `depthwise` and `pointwise`). Its `shuffle_in_channels` permutation
  is lama_tpu's draw (RandomState(0), a 'constants' collection that no
  exported checkpoint carries), so it is a non-persistent buffer here; a
  checkpoint that does hold `in_channels_permute` loads it into the buffer.
Every parameter stays float32, a model runs in its `dtype` (float32 or
bfloat16; float64 for reference checks), BatchNorm and the output activation
compute in float32. `kernels='plain'` sends the kernels' shapes to their
plain versions. A generator's `mode` (ops/serving_mode.py) reaches its
convs: under int8 the eligible ones quantize (the downsamples, the block
convs, each multidilated branch and the ConvTranspose layers; a depthwise
conv never: its contraction is 1), with the pads placed as in lama_tpu
(each block pad folded into its conv, so zero_pad turns it to zeros; the
downsamples are zero-padded with or without it). A MultidilatedConv's
dilation-1 branch of a reflect block is kernel 3 or 6's shape; its dilated
branches, the depthwise convs, the downsamples, the ConvTranspose layers
and the 4x4 discriminator convs go to the stock conv, as lama_tpu leaves
them to XLA.
"""
import numpy as np
import torch
import torch.nn as nn

from ..ops.activations import leaky_relu_02
from ..ops.conv import Conv2d, ConvTranspose2d
from ..ops.norm import BatchNorm2d
from ..ops.precision import check_dtype
from ..ops.serving_mode import DEFAULT as DEFAULT_MODE
from .ffc import FFCResnetBlock, _Activation

# the pad modes of lama_tpu's padding_type names ('zero' pads with zeros)
_PAD_MODES = {'reflect': 'reflect', 'replicate': 'replicate'}


def pad_mode(padding_type):
    return _PAD_MODES.get(padding_type, 'zeros')


class _LeakyReLU(nn.Module):
    def forward(self, x):
        return leaky_relu_02(x)


class DepthWiseSeparableConv(nn.Module):
    """A depthwise conv (groups = in_dim) and a 1x1 pointwise conv
    (reference depthwise_sep_conv.py; lama_tpu pix2pixhd.py:37-57). Keys:
    depthwise, pointwise."""

    def __init__(self, in_dim, out_dim, kernel_size=3, stride=1, padding=0,
                 dilation=1, padding_mode='zeros', kernels='cuda',
                 mode=DEFAULT_MODE):
        super().__init__()
        self.depthwise = Conv2d(in_dim, in_dim, kernel_size, stride=stride,
                                padding=padding, dilation=dilation,
                                groups=in_dim, padding_mode=padding_mode,
                                kernels=kernels, mode=mode)
        self.pointwise = Conv2d(in_dim, out_dim, 1, kernels=kernels,
                                mode=mode)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


def _split_dims(dim, n, equal):
    """lama_tpu's channel shares of n branches: equal parts, or halves
    down to the last, which takes the rest."""
    if equal:
        if dim % n:
            raise ValueError(f'{dim} channels do not split into {n} equal '
                             'parts')
        return [dim // n] * n
    dims = [dim // 2 ** (i + 1) for i in range(n - 1)]
    return dims + [dim - sum(dims)]


class MultidilatedConv(nn.Module):
    """Parallel convs at dilations min_dilation * 2^i, i < dilation_num,
    combined by a sum ('sum', 'cat_in') or an interleaved concatenation
    ('cat_out', 'cat_both'); 'cat_in' and 'cat_both' give each branch its
    own share of the input channels (reference multidilated_conv.py:6-98;
    lama_tpu pix2pixhd.py:60-139). `padding` is multiplied by each
    branch's dilation, or a list gives each branch its own. Keys:
    convs.{i}."""

    def __init__(self, in_dim, out_dim, kernel_size=3, dilation_num=3,
                 comb_mode='sum', equal_dim=True, padding=1, min_dilation=1,
                 stride=1, use_depthwise=False, padding_mode='zeros',
                 shuffle_in_channels=False, kernels='cuda',
                 mode=DEFAULT_MODE):
        super().__init__()
        if comb_mode not in ('cat_out', 'sum', 'cat_in', 'cat_both'):
            raise ValueError(f'comb_mode={comb_mode!r}')
        self.cat_out = comb_mode in ('cat_out', 'cat_both')
        self.cat_in = comb_mode in ('cat_in', 'cat_both')
        if self.cat_out:
            out_dims = _split_dims(out_dim, dilation_num, equal_dim)
            if equal_dim:
                index = [i + j * out_dims[0] for i in range(out_dims[0])
                         for j in range(dilation_num)]
            else:
                index, starts = [], [0] + out_dims[:-1]
                lengths = [out_dims[i] // out_dims[-1]
                           for i in range(dilation_num)]
                for _ in range(out_dims[-1]):
                    for j in range(dilation_num):
                        index += range(starts[j], starts[j] + lengths[j])
                        starts[j] += lengths[j]
            self.register_buffer('index', torch.tensor(index),
                                 persistent=False)
        else:
            out_dims = [out_dim] * dilation_num
        self.in_dims = (_split_dims(in_dim, dilation_num, equal_dim)
                        if self.cat_in else [in_dim] * dilation_num)
        self.register_buffer(
            'in_channels_permute',
            torch.from_numpy(np.random.RandomState(0).permutation(in_dim))
            if shuffle_in_channels else None, persistent=False)
        padding_mode = pad_mode(padding_mode)
        convs, dilation = [], min_dilation
        for i in range(dilation_num):
            p = padding * dilation if isinstance(padding, int) else padding[i]
            kw = dict(kernel_size=kernel_size, stride=stride, padding=p,
                      dilation=dilation, padding_mode=padding_mode,
                      kernels=kernels, mode=mode)
            convs.append(DepthWiseSeparableConv(self.in_dims[i], out_dims[i],
                                                **kw) if use_depthwise
                         else Conv2d(self.in_dims[i], out_dims[i], **kw))
            dilation *= 2
        self.convs = nn.ModuleList(convs)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a checkpoint that keeps the permutation (the reference registers
        # it as a buffer) sets it; one without it keeps lama_tpu's draw
        key = prefix + 'in_channels_permute'
        if key in state_dict and self.in_channels_permute is not None:
            self.in_channels_permute = state_dict.pop(key).to(
                self.in_channels_permute)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        if self.in_channels_permute is not None:
            x = x[:, self.in_channels_permute]
        inputs = (torch.split(x, self.in_dims, dim=1) if self.cat_in
                  else [x] * len(self.convs))
        outs = [conv(t) for conv, t in zip(self.convs, inputs)]
        if self.cat_out:
            return torch.cat(outs, dim=1)[:, self.index]
        # summed in lama_tpu's order; the first branch (dilation 1, on a
        # kernel where the block is reflect-padded, channels-last) leads,
        # since a sum takes its first operand's memory format
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out


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


class MultidilatedNLayerDiscriminator(NLayerDiscriminator):
    """NLayerDiscriminator with a MultidilatedConv (stride 2, padding
    [2, 3] by dilation, so `multidilation_kwargs` needs dilation_num 2) in
    each of `model1..model{n-1}` (reference pix2pixhd.py:616-664; lama_tpu
    pix2pixhd.py:456-498). Keys: `model1.0.convs.{i}.weight`, ..."""

    def __init__(self, input_nc=3, ndf=64, n_layers=3,
                 multidilation_kwargs=None, dtype=torch.float32,
                 kernels='cuda'):
        super().__init__(input_nc, ndf, n_layers, dtype, kernels)
        nf = ndf
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            getattr(self, f'model{n}')[0] = MultidilatedConv(
                nf_prev, nf, kernel_size=4, stride=2, padding=[2, 3],
                kernels=kernels, **dict(multidilation_kwargs or {}))


class ResnetBlock(nn.Module):
    """conv -> BN -> activation -> conv -> BN, plus the residual (reference
    pix2pixhd.py:30-92; lama_tpu pix2pixhd.py:142-188). padding_type
    reflect, replicate or zero; kernel_size 3 or 5 (which doubles the pad);
    conv_kind 'depthwise' makes each conv a DepthWiseSeparableConv;
    `in_dim` adds the 1x1 `input_conv` on the residual. Keys:
    conv_block.{1,2,5,6}, input_conv."""

    def __init__(self, dim, padding_type='reflect', activation='relu',
                 conv_kind='default', dilation=1, second_dilation=None,
                 in_dim=None, groups=1, kernel_size=3, kernels='cuda',
                 mode=DEFAULT_MODE):
        super().__init__()
        if second_dilation is None:
            second_dilation = dilation
        pad_mult = 2 if kernel_size == 5 else 1

        def conv(cin, d, g):
            kw = dict(padding=d * pad_mult, dilation=d,
                      padding_mode=pad_mode(padding_type), kernels=kernels,
                      mode=mode)
            if conv_kind == 'depthwise':   # `groups` does not reach it
                return DepthWiseSeparableConv(cin, dim, kernel_size, **kw)
            return Conv2d(cin, dim, kernel_size, groups=g, **kw)

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


class MultidilatedResnetBlock(nn.Module):
    """MultidilatedConv -> BN -> activation -> MultidilatedConv -> BN, plus
    the residual (reference pix2pixhd.py:156-175; lama_tpu
    pix2pixhd.py:191-214); both convs 3x3, padded by `padding_type`. Keys:
    conv_block.{0,1,3,4}."""

    def __init__(self, dim, padding_type='reflect', activation='relu',
                 multidilation_kwargs=None, kernels='cuda',
                 mode=DEFAULT_MODE):
        super().__init__()
        kw = dict(kernel_size=3, padding_mode=padding_type, kernels=kernels,
                  mode=mode, **dict(multidilation_kwargs or {}))
        self.conv_block = nn.Sequential(
            MultidilatedConv(dim, dim, **kw), BatchNorm2d(dim),
            _Activation(activation), MultidilatedConv(dim, dim, **kw),
            BatchNorm2d(dim))

    def forward(self, x):
        return self.conv_block(x) + x


def _encoder(input_nc, ngf, n_downsampling, max_features, activation,
             kernels, mode):
    """The generators' first Sequential entries: 0 pad (folded into 1), 1
    the 7x7 reflect stem conv, 2 BN, 3 activation, then each downsample
    (3x3 stride 2, zero padding) conv, BN, activation."""
    layers = [nn.Identity(),
              Conv2d(input_nc, ngf, 7, padding=3, padding_mode='reflect',
                     kernels=kernels, mode=mode),
              BatchNorm2d(ngf), _Activation(activation)]
    for i in range(n_downsampling):
        cin = min(max_features, ngf * 2 ** i)
        cout = min(max_features, ngf * 2 ** (i + 1))
        layers += [Conv2d(cin, cout, 3, stride=2, padding=1,
                          kernels=kernels, mode=mode),
                   BatchNorm2d(cout), _Activation(activation)]
    return layers


def _decoder(output_nc, ngf, n_downsampling, max_features, up_activation,
             add_out_act, kernels, mode):
    """The generators' last Sequential entries: each upsample
    ConvTranspose, BN, up_activation; a pad index (folded into the head),
    the 7x7 reflect head conv and the output activation, in float32."""
    layers = []
    for i in range(n_downsampling):
        mult = 2 ** (n_downsampling - i)
        cout = min(max_features, int(ngf * mult / 2))
        layers += [ConvTranspose2d(min(max_features, ngf * mult), cout,
                                   kernel_size=3, stride=2, padding=1,
                                   output_padding=1, kernels=kernels,
                                   mode=mode),
                   BatchNorm2d(cout), _Activation(up_activation)]
    layers += [nn.Identity(),
               Conv2d(ngf, output_nc, 7, padding=3, padding_mode='reflect',
                      kernels=kernels, mode=mode)]
    if add_out_act:
        layers.append(_Activation(
            'tanh' if add_out_act is True else add_out_act, float32=True))
    return layers


def _ffc_block(feats, padding_type, ffc_kwargs, kernels, mode):
    """The inline FFCResnetBlock of `ffc_positions` (lama_tpu
    pix2pixhd.py:285-298): ratio 0.75 and LFU unless ffc_kwargs says
    otherwise."""
    kw = dict(ffc_kwargs or {})
    return FFCResnetBlock(feats, padding_type=padding_type,
                          activation='relu', inline=True,
                          ratio_gin=kw.get('ratio_gin', 0.75),
                          ratio_gout=kw.get('ratio_gout', 0.75),
                          enable_lfu=kw.get('enable_lfu', True),
                          kernels=kernels, mode=mode)


class _Generator(nn.Module):
    """A generator whose `self.model` Sequential takes the whole image."""

    def forward(self, x):
        """(B, input_nc, H, W) -> (B, output_nc, H, W): float32 when an
        output activation is set, else `dtype`. Works channels-last."""
        return self.model(x.to(self.dtype).contiguous(
            memory_format=torch.channels_last))


class GlobalGenerator(_Generator):
    """The pix2pixHD conv-ResNet generator (reference pix2pixhd.py:341-436;
    lama_tpu pix2pixhd.py:217-326), `kind='pix2pixhd_global'`, NCHW.
    big-lama-regular: input_nc=4, ngf=64, n_downsampling=3, n_blocks=18,
    add_out_act='sigmoid' (lama-regular: 9 blocks).

    `self.model` is an nn.Sequential with the reference's indices: 0 pad,
    1 the 7x7 stem conv, 2 BN, 3 activation; each downsample (3x3 stride 2,
    zero padding) conv, BN, activation; the dilated and plain ResnetBlocks
    at max_features-capped width, with `ffc_positions.count(i)` inline
    FFCResnetBlocks before plain block i; each upsample ConvTranspose, BN,
    up_activation; a pad index, the 7x7 head conv, and the output
    activation, which runs in float32. `is_resblock_depthwise` makes each
    plain block's second conv depthwise (groups = its width)."""

    def __init__(self, input_nc=4, output_nc=3, ngf=64, n_downsampling=3,
                 n_blocks=9, padding_type='reflect', conv_kind='default',
                 activation='relu', up_activation='relu', dilated_blocks_n=0,
                 dilated_blocks_n_start=0, dilated_blocks_n_middle=0,
                 add_out_act=True, max_features=1024,
                 is_resblock_depthwise=False, ffc_positions=None,
                 ffc_kwargs=None, dilation=1, second_dilation=None,
                 dtype=torch.float32, kernels='cuda', mode=DEFAULT_MODE):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.mode = mode
        layers = _encoder(input_nc, ngf, n_downsampling, max_features,
                          activation, kernels, mode)
        feats = min(max_features, ngf * 2 ** n_downsampling)
        block = dict(padding_type=padding_type, activation=activation,
                     conv_kind=conv_kind, kernels=kernels, mode=mode)

        def dilated_blocks(n):
            return [ResnetBlock(feats, dilation=2 ** (j + 1), **block)
                    for j in range(n)]

        ffc_positions = list(ffc_positions or [])
        layers += dilated_blocks(dilated_blocks_n_start)
        for i in range(n_blocks):
            if i == n_blocks // 2:
                layers += dilated_blocks(dilated_blocks_n_middle)
            layers += [_ffc_block(feats, padding_type, ffc_kwargs, kernels,
                                  mode) for _ in range(ffc_positions.count(i))]
            layers.append(ResnetBlock(
                feats, dilation=dilation, second_dilation=second_dilation,
                groups=feats if is_resblock_depthwise else 1, **block))
        layers += dilated_blocks(dilated_blocks_n)
        layers += _decoder(output_nc, ngf, n_downsampling, max_features,
                           up_activation, add_out_act, kernels, mode)
        self.model = nn.Sequential(*layers)


class MultiDilatedGlobalGenerator(_Generator):
    """The multidilated generator (reference pix2pixhd.py:178-237; lama_tpu
    pix2pixhd.py:329-407), `kind='pix2pixhd_multidilated'`, NCHW:
    GlobalGenerator's stem, downsamples, upsamples and head at the same
    indices, with n_blocks MultidilatedResnetBlocks (`multidilation_kwargs`
    for their convs) and an inline FFCResnetBlock before block i for each
    i in `ffc_positions`. configs/training/ablv2_work_md.yaml's
    (pix2pixhd_multidilated_catin_4dil_9b): ngf 64, 3 downsamplings, 9
    blocks at 512 channels, comb_mode cat_in, dilation_num 4 (dilations 1,
    2, 4 and 8, each branch 128 -> 512), sigmoid."""

    def __init__(self, input_nc=4, output_nc=3, ngf=64, n_downsampling=3,
                 n_blocks=3, padding_type='reflect', activation='relu',
                 up_activation='relu', add_out_act=True, max_features=1024,
                 multidilation_kwargs=None, ffc_positions=None,
                 ffc_kwargs=None, dtype=torch.float32, kernels='cuda',
                 mode=DEFAULT_MODE):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.mode = mode
        layers = _encoder(input_nc, ngf, n_downsampling, max_features,
                          activation, kernels, mode)
        feats = min(max_features, ngf * 2 ** n_downsampling)
        ffc_positions = list(ffc_positions or [])
        for i in range(n_blocks):
            if i in ffc_positions:
                layers.append(_ffc_block(feats, padding_type, ffc_kwargs,
                                         kernels, mode))
            layers.append(MultidilatedResnetBlock(
                feats, padding_type=padding_type, activation=activation,
                multidilation_kwargs=multidilation_kwargs, kernels=kernels,
                mode=mode))
        layers += _decoder(output_nc, ngf, n_downsampling, max_features,
                           up_activation, add_out_act, kernels, mode)
        self.model = nn.Sequential(*layers)
