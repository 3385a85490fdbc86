"""Seeded random weights for the score and loss networks, whose published
weights are not in this repository (the FID InceptionV3, the torchvision
VGG16, AlexNet and SqueezeNet trunks).

Every conv weight is drawn from N(0, 2 / fan_in) and every conv bias is
zero, from one `torch.Generator` seeded with `seed`, in the module's
parameter order; BatchNorm keeps its identity (weight 1, bias 0, mean 0,
var 1). The He scale keeps the activations' size through the depth of
these nets: PyTorch's default (and the JAX package's) uniform +-1/sqrt(fan_in)
shrinks them by about 6x a layer, which leaves the FID InceptionV3's pooled
features near 1e-7 and every FID near zero. Scores with these weights are
only self-consistent: they do not compare with published numbers.

Identity BatchNorm statistics leave a deep residual net's trunk doubling
its variance at each block (the ADE20k resnet50dilated's logits reach ~1e3)
and every channel's mean in place, so one class wins almost everywhere.
`calibrate_batchnorm_` sets each BatchNorm's running statistics from one
train-mode forward on sample inputs, as training would leave them.
"""
import math

import torch
import torch.nn as nn


@torch.no_grad()
def seeded_random_init_(module: nn.Module, seed: int = 0) -> nn.Module:
    gen = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=gen) * math.sqrt(2.0 / fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return module


@torch.no_grad()
def calibrate_batchnorm_(module: nn.Module, *inputs) -> nn.Module:
    """One forward of `module(*inputs)` in train mode with momentum 1: each
    BatchNorm normalises by the batch's statistics and keeps them (the
    unbiased variance) as its running ones, after the BatchNorms before it
    have done the same. Returns `module` in eval mode."""
    norms = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    module.train()
    module(*inputs)
    for m, momentum in zip(norms, momenta):
        m.momentum = momentum
    return module.eval()
