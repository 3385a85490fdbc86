"""The VGG16 feature trunk in torchvision's layout, NCHW (counterpart of
lama_tpu/models/aux/vgg.py).

Used by LPIPS (vgg16 relu1_2 .. relu5_3; reference evaluation/losses/
lpips.py PNetLin). The trunk is an
`nn.Sequential` named `features` whose entries sit at torchvision's
indices (conv, ReLU, pool), so a torchvision state_dict's
`features.N.weight` / `features.N.bias` keys load with strict=True.
"""
from typing import List

import torch
import torch.nn as nn

from ...ops.conv import Conv2d

VGG16_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
             512, 512, 512, 'M', 512, 512, 512, 'M']

# torch sequential indices of the relu outputs LPIPS taps (vgg16):
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
VGG16_LPIPS_TAPS = (3, 8, 15, 22, 29)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x):
    """[0, 1] RGB NCHW -> ImageNet-normalised (reference perceptual.py:10-11)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean[:, None, None]) / std[:, None, None]


class VGGFeatures(nn.Module):
    """Runs the VGG16 `features` trunk and returns the activations after
    each layer index in VGG16_LPIPS_TAPS (torch sequential indices)."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for v in VGG16_CFG:
            if v == 'M':
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(in_ch, v, 3, padding=1), nn.ReLU()]
                in_ch = v
        self.features = nn.Sequential(*layers)

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in VGG16_LPIPS_TAPS:
                taps.append(x)
        return taps
