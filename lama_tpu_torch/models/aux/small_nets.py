"""AlexNet and SqueezeNet 1.1 feature trunks in torchvision's layout, NCHW
(counterpart of lama_tpu/models/aux/small_nets.py): the other LPIPS
backbones, net='alex' and net='squeeze' (reference evaluation/losses/
lpips.py PNetLin).

Each trunk is an `nn.Sequential` named `features` with its entries at
torchvision's indices, so `features.N.*` keys (and a Fire module's
`squeeze`, `expand1x1`, `expand3x3`) load from a torchvision state_dict.
The max pools take floor windows, as the JAX package's do; torchvision's
SqueezeNet pools with ceil_mode=True, which gives one more row and column
where a size is even.
"""
from typing import List

import torch
import torch.nn as nn

from ...ops.conv import Conv2d

# richzhang taps: relu outputs after each conv stage
ALEXNET_TAPS = (1, 4, 7, 9, 11)
ALEXNET_TAP_CHANNELS = (64, 192, 384, 256, 256)

# richzhang squeeze slices: relu1, fire3, fire5, fire6, fire7, fire8, fire9
SQUEEZE_TAPS = (1, 4, 7, 9, 10, 11, 12)
SQUEEZE_TAP_CHANNELS = (64, 128, 256, 384, 384, 512, 512)


class _Trunk(nn.Module):
    taps = ()

    def __init__(self, layers):
        super().__init__()
        self.features = nn.Sequential(*layers)

    def forward(self, x) -> List[torch.Tensor]:
        out = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.taps:
                out.append(x)
        return out


class AlexNetFeatures(_Trunk):
    """torchvision AlexNet `features`; returns the relu activations at
    ALEXNET_TAPS."""
    taps = ALEXNET_TAPS

    def __init__(self):
        super().__init__([
            Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            Conv2d(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            Conv2d(256, 256, 3, padding=1), nn.ReLU(),
        ])


class Fire(nn.Module):
    """SqueezeNet fire module: 1x1 squeeze, then 1x1 and 3x3 expands
    concatenated."""

    def __init__(self, in_ch, squeeze_ch, expand1x1_ch, expand3x3_ch):
        super().__init__()
        self.squeeze = Conv2d(in_ch, squeeze_ch, 1)
        self.expand1x1 = Conv2d(squeeze_ch, expand1x1_ch, 1)
        self.expand3x3 = Conv2d(squeeze_ch, expand3x3_ch, 3, padding=1)

    def forward(self, x):
        s = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1x1(s)),
                          torch.relu(self.expand3x3(s))], dim=1)


class SqueezeNetFeatures(_Trunk):
    """torchvision SqueezeNet 1.1 `features`; returns the 7 taps the LPIPS
    'squeeze' variant calibrates."""
    taps = SQUEEZE_TAPS

    def __init__(self):
        super().__init__([
            Conv2d(3, 64, 3, stride=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
            nn.MaxPool2d(3, 2),
            Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
            nn.MaxPool2d(3, 2),
            Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
            Fire(384, 64, 256, 256), Fire(512, 64, 256, 256),
        ])
