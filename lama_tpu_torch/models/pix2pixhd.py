"""The pix2pixHD PatchGAN discriminator big-lama trains against
(counterpart of lama_tpu/models/pix2pixhd.py:410-453, NLayerDiscriminator;
reference pix2pixhd.py:565-613).

The module tree mirrors the reference: `model0` (conv, LeakyReLU),
`model1..model{n-1}` (stride-2 conv, BN, LeakyReLU), `model{n}` (stride-1
conv, BN, LeakyReLU) and `model{n+1}` (the 1-channel score conv), so the
keys are `model0.0.weight`, `model1.1.running_mean`, ... Convs are 4x4 with
zero padding 2 and a bias; they run in the discriminator's `dtype` (float32
or bfloat16), with float32 parameters and BatchNorm computing in float32.
"""
import torch
import torch.nn as nn

from ..ops.activations import leaky_relu_02
from ..ops.conv import Conv2d
from ..ops.norm import BatchNorm2d
from ..ops.precision import check_dtype


class _LeakyReLU(nn.Module):
    def forward(self, x):
        return leaky_relu_02(x)


class NLayerDiscriminator(nn.Module):
    """(B, input_nc, H, W) -> (score (B, 1, h, w), [the outputs of stages
    0..n_layers]), the features feature matching compares
    (trainers/default.py:128)."""

    def __init__(self, input_nc=3, ndf=64, n_layers=3, dtype=torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.n_layers = n_layers
        kw = dict(kernel_size=4, padding=2)
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
